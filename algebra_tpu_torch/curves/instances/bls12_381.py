"""BLS12-381: the base and scalar prime fields.

Parameters are the standard public BLS12-381 constants; every derived
constant comes from the field compiler.  Curves, towers and pairing
parameters are not here yet.
"""

from __future__ import annotations

from ...fields.prime import prime_field
from ...fields.spec import field_spec

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

fq_spec = field_spec(P, generator=2, name="bls12_381.Fq")
fr_spec = field_spec(
    R, generator=7, small_subgroup_base=3, small_subgroup_power=1, name="bls12_381.Fr"
)

# Field kinds on the default device; ``Fr.to("cpu")`` gives the CPU kind.
Fq = prime_field(fq_spec)
Fr = prime_field(fr_spec)
