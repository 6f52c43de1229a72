"""One CUDA graph launch per looped decode block (``csrc/graph_loop.cu``).

The engine captures a looped block's prologue and one loop iteration as
two PyTorch graphs (``torch.cuda.CUDAGraph(keep_graph=True)``); this
module hands their ``cudaGraph_t`` handles to the C source, which builds
an outer graph with a conditional WHILE node around the iteration and
instantiates it. A launch then runs the prologue and as many iterations
as the device's continue flag allows, with no host round trip.

The source is built by ``ops/kernels/_build.py`` on first use and bound
with ctypes. Everything raises on failure: there is no eager fallback.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from distributed_inference_server_tpu_torch.ops.kernels import _build


def _lib():
    lib = _build.load("graph_loop")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.graph_loop_build.argtypes = [vp, vp, vp, ctypes.POINTER(vp),
                                         ctypes.POINTER(ci)]
        lib.graph_loop_build.restype = ci
        lib.graph_loop_launch.argtypes = [vp, vp]
        lib.graph_loop_launch.restype = ci
        lib.graph_loop_destroy.argtypes = [vp]
        lib.graph_loop_destroy.restype = ci
        lib.graph_loop_versions.argtypes = [ctypes.POINTER(ci),
                                            ctypes.POINTER(ci)]
        lib.graph_loop_versions.restype = ci
        lib.graph_loop_error_string.argtypes = [ci]
        lib.graph_loop_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _error(lib, err: int, what: str) -> RuntimeError:
    cuda, rt = ctypes.c_int(0), ctypes.c_int(0)
    lib.graph_loop_versions(ctypes.byref(cuda), ctypes.byref(rt))
    msg = lib.graph_loop_error_string(err).decode()
    return RuntimeError(f"{what}: CUDA error {err} ({msg}); CUDA "
                        f"{cuda.value}, runtime {rt.value}")


class LoopGraph:
    """The instantiated outer graph of one looped block. ``prologue`` and
    ``body`` are the captured PyTorch graphs (kept alive here: their
    memory pool holds the tensors the graph's kernels read and write);
    ``flag`` is the device int32 that both write (nonzero = run another
    iteration)."""

    def __init__(self, prologue: torch.cuda.CUDAGraph,
                 body: torch.cuda.CUDAGraph, flag: torch.Tensor):
        lib = _lib()
        handle = ctypes.c_void_p()
        result = ctypes.c_int(-1)
        err = lib.graph_loop_build(
            ctypes.c_void_p(prologue.raw_cuda_graph()),
            ctypes.c_void_p(body.raw_cuda_graph()),
            ctypes.c_void_p(flag.data_ptr()), ctypes.byref(handle),
            ctypes.byref(result))
        if err != 0:
            raise _error(lib, err, "building the looped block's WHILE graph "
                         f"(instantiate result {result.value})")
        self._handle = handle.value
        self._graphs = (prologue, body, flag)
        self._finalizer = weakref.finalize(self, lib.graph_loop_destroy,
                                           ctypes.c_void_p(handle.value))

    def launch(self, stream: torch.cuda.Stream) -> None:
        lib = _lib()
        err = lib.graph_loop_launch(ctypes.c_void_p(self._handle),
                                    ctypes.c_void_p(stream.cuda_stream))
        if err != 0:
            raise _error(lib, err, "launching the looped block's graph")
