"""repro_torch — the Bourbon learned-index LSM store on PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference).  Nothing is
set globally on import: dtypes are explicit (int64 keys, float64 PLR math)
and every tensor the engine builds names its device.
"""

__version__ = "0.1.0"
