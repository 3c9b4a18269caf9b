"""PyTorch / CUDA port of super_rag_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``ops/``, ``engine/``,
``tokenize/``, ``models/``) and imports only ``torch``, ``numpy`` and the
standard library.  Entry points take an explicit ``device`` that defaults
to CUDA and raise when no card is present (see ``device.py``); the tests
pass ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.
"""


def __getattr__(name: str):
    # resolved on first use, so host-only modules (the ingest worker
    # process, tasks/worker.py) import the package without torch
    if name == "resolve_device":
        from super_rag_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["resolve_device"]
