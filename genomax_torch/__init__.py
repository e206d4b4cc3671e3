"""genomax_torch — the genomax scoring engine on PyTorch and CUDA.

The port of the JAX package ``genomax`` to one NVIDIA H100. The jax-free
host layer of ``genomax`` (input formats, packing, layout constants,
``SWConfig``, ``PairHMMConfig``, the native golden model and the numpy
oracle) is imported, not copied; this package adds what runs on the card:

    config.py           engine knobs of the ported paths (explicit device)
    pack.py             packed buckets -> tensors on a device
    kernels/wavefront   plain PyTorch SW and PairHMM wavefronts (references)
    kernels/expand      PairHMM quality expansion and factored gather
    kernels/sw          wrapper of the hand-written CUDA SW kernel
    kernels/pairhmm     wrapper of the hand-written CUDA PairHMM kernel
    kernels/pairhmm_long  long-read PairHMM: pack, CUDA kernel wrapper, driver
    kernels/_build      nvcc build of csrc/ at first use, loaded with ctypes
    csrc/               CUDA C++ sources for sm_90a
    engine/executor     Engine: offload, pack, launch, unpack, fp64 fallback
    cli/                ``python -m genomax_torch sw|pairhmm``

Importing the package imports neither jax nor torch and compiles nothing.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: keep `import genomax_torch` free of torch and of any build.
    if name == "Engine":
        from genomax_torch.engine.executor import Engine

        return Engine
    if name == "SWConfig":
        from genomax.config import SWConfig

        return SWConfig
    if name == "PairHMMConfig":
        from genomax.config import PairHMMConfig

        return PairHMMConfig
    raise AttributeError(name)
