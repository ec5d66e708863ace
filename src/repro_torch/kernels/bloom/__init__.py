from .ops import bloom_build, bloom_probe
from .ref import bloom_build_ref, bloom_probe_ref

__all__ = ["bloom_build", "bloom_build_ref", "bloom_probe",
           "bloom_probe_ref"]
