"""Package version (kept equal to the JAX package's ``gsplat_tpu.version``)."""

__version__ = "0.2.0"
REFERENCE_VERSION = "1.4.1"
