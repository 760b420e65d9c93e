"""MNT4-753: the 753-bit base prime field (the 48-limb kernel case), with
small-subgroup base 5, and G1's coefficient a (the a != 0 case of the
affine tree's halving level).  The scalar field and the curve are not here
yet.
"""

from __future__ import annotations

from ...fields.prime import prime_field
from ...fields.spec import field_spec

P = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888253786114353726529584385201591605722013126468931404347949840543007986327743462853720628051692141265303114721689601

COEFF_A = 2  # G1: y^2 = x^3 + 2 x + b

fq_spec = field_spec(P, generator=17, small_subgroup_base=5,
                     small_subgroup_power=2, name="mnt4_753.Fq")

Fq = prime_field(fq_spec)
