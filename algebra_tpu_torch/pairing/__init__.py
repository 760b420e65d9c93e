from .bls12 import Bls12  # noqa: F401
