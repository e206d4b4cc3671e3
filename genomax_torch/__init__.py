"""genomax_torch — the genomax scoring engine on PyTorch and CUDA.

The port of the JAX package ``genomax`` to one NVIDIA H100. It stands on
its own: it imports torch and numpy, never jax, and nothing of ``genomax``.
What it needs of the JAX package's host layer it keeps as a copy under the
same module name, held equal to the original by the tests:

    layout.py           tile-layout constants shared by packs and kernels
    config.py           SWConfig, PairHMMConfig; EngineConfig (explicit device)
    io/                 input formats, phred decode, seeded generators
    native/             golden.cpp: exact SW and fp64 PairHMM models and the
                        packers' fill loops, built by g++ at first use
    pack/bucketing      ragged jobs -> dense numpy tiles, bucketed
    pack/tensors        packed buckets -> tensors on a device
    kernels/wavefront   plain PyTorch SW and PairHMM wavefronts (references)
    kernels/expand      PairHMM quality expansion and factored gather
    kernels/sw          wrapper of the hand-written CUDA SW kernel
    kernels/sw_long     long-pair SW: pack, CUDA kernel wrapper, tile loop
    kernels/sw_strips   strip-mined SW: width rule, re-pad, predicate, wrapper
    kernels/sw_rotor    rotor SW: lane-queue pack and prep, predicate, wrappers
    kernels/sw_stacked  stacked SW: re-stack S tiles deep, predicate, wrapper
    kernels/sw_conveyor conveyor SW: pack, unpack, wrapper, library entry
    kernels/pairhmm     wrapper of the hand-written CUDA PairHMM kernel
    kernels/pairhmm_long  long-read PairHMM: pack, CUDA kernel wrapper, tile loop
    kernels/_build      nvcc build of csrc/ at first use, loaded with ctypes
    csrc/               CUDA C++ sources for sm_90a
    engine/executor     Engine: pack, launch, unpack, long-pair kernels,
                        native offload, fp64 fallback
    dist/               multi-device: torch.distributed mesh, tile-sharded
                        buckets, ShardedEngine, the cross-device SW
                        wavefront (csrc/sw_xstrip.cu)
    cli/                ``python -m genomax_torch sw|pairhmm``
    trace.py            the engine's spans and counters, recorded while a
                        torch.profiler records (PERF.md names them)

Importing the package imports neither jax nor torch and compiles nothing.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: keep `import genomax_torch` free of torch and of any build.
    if name == "Engine":
        from genomax_torch.engine.executor import Engine

        return Engine
    if name == "SWConfig":
        from genomax_torch.config import SWConfig

        return SWConfig
    if name == "EngineConfig":
        from genomax_torch.config import EngineConfig

        return EngineConfig
    if name == "PairHMMConfig":
        from genomax_torch.config import PairHMMConfig

        return PairHMMConfig
    raise AttributeError(name)
