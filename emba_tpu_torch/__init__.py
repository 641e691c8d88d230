"""emba_tpu_torch — the PyTorch and CUDA port of emba_tpu.

The same bundle adjustment (LEGM linearization, Schur-structured normal
equations, LM window solve) on torch tensors, with the normal-equation
accumulation as a hand-written CUDA kernel for Hopper
(``kernels/csrc/a12_accum.cu``) and the fused window replayed from CUDA
graphs; ``probes/`` measures the card (the gather floor). Modules keep the
names and argument order of their ``emba_tpu`` counterparts. The port imports
nothing of JAX or of ``emba_tpu``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API."""
    import importlib

    api = {
        "Trajectory": ("spline", "Trajectory"),
        "PinholeCamera": ("camera", "PinholeCamera"),
        "EquirectangularCamera": ("camera", "EquirectangularCamera"),
        "ModelConfig": ("model", "ModelConfig"),
        "DeviceWindow": ("model", "DeviceWindow"),
        "LMConfig": ("solver", "LMConfig"),
        "solve_window": ("solver", "solve_window"),
        "solve_window_fused": ("solver", "solve_window_fused"),
        "require_cuda": ("device", "require_cuda"),
    }
    if name in api:
        mod, attr = api[name]
        return getattr(importlib.import_module(f".{mod}", __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
