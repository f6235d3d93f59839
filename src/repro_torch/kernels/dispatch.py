"""Device resolution, kernel launch counts and the CUDA kernel build.

The port's counterpart of `repro.kernels.dispatch`: instead of sniffing a
platform, every entry point takes a `device`, and every kernel wrapper
dispatches on the device of the tensors it is given — a CPU tensor runs
the kernel's plain PyTorch version, a CUDA tensor runs the CUDA kernel.

The CUDA sources in `csrc/` are compiled on first use with `nvcc` into
shared libraries with a plain C interface (loaded with ctypes), under
`build/kernels/` at the repository root; the library name carries a hash
of its source and of the shared headers (`csrc/*.cuh`), so an edited
source is rebuilt. `build_kernels()` starts one `nvcc` per source, all at
once, and waits for them.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

KERNEL_NAMES = ("ebg_commit", "bsp_superstep", "segment_reduce", "ebg_membership", "decode_attn",
                "decode_attn_wide")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # Bit parity with the reference: no a*b+c is contracted into an FMA
    # unless the source writes the FMA out; IEEE division and square root.
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches by kernel name; each CUDA wrapper adds one per launch.
# A CUDA graph's replay launches with no Python: the launches its capture
# recorded (`captured_launches`) are added at every replay (`add_launches`).
LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCTIONS: dict = {}
_THREAD = threading.local()


def reset_launches() -> None:
    LAUNCHES.clear()


def captured_launches(fn) -> collections.Counter:
    """Call `fn` (which a CUDA graph is capturing) and return the launches
    its wrappers counted, taken back out of `LAUNCHES`: a capture launches
    nothing; each replay of the graph launches them (`add_launches`)."""
    before = collections.Counter(LAUNCHES)
    fn()
    made = collections.Counter({k: v - before[k] for k, v in LAUNCHES.items() if v > before[k]})
    LAUNCHES.subtract(made)
    return made


def add_launches(counts: collections.Counter) -> None:
    """Count the launches of one replay of a captured graph."""
    LAUNCHES.update(counts)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. None means the CUDA card, and
    raises when there is none: the port never falls back to the CPU
    silently — pass device="cpu" to run the plain PyTorch versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be a CPU or CUDA device, got {device!r}")
    return dev


def _source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha1(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the sources share these
        digest.update(header.read_bytes())
    digest = hashlib.sha1(digest.digest() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(cand)


def build_kernels(names=KERNEL_NAMES) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Returns {name: ptxas report} for the
    kernels compiled by this call; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The built library of kernel `name`, compiled on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_kernels((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def c_function(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """The C entry `symbol` of kernel `name`'s library, its argument and
    result types set once (the loaded function is kept, so a call pays no
    setup)."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCTIONS[name, symbol] = fn
    return fn


def host_flag(name: str):
    """This thread's 4 bytes of mapped pinned host memory for kernel
    `name`'s error flag (its C entry `<name>_host_flag` allocates them):
    (host pointer, device pointer, the host's view of it). They stay
    allocated for the thread's life."""
    flags = getattr(_THREAD, "flags", None)
    if flags is None:
        flags = _THREAD.flags = {}
    flag = flags.get(name)
    if flag is None:
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        fn = c_function(name, f"{name}_host_flag", [ctypes.c_void_p] * 2)
        check_launch(f"{name}_host_flag", fn(ctypes.byref(host), ctypes.byref(dev)))
        flag = flags[name] = (host.value, dev.value, ctypes.c_uint32.from_address(host.value))
    return flag


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C launch entry."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def cuda_stream_handle() -> int:
    """PyTorch's current CUDA stream on the current device, as a raw handle
    (the raw query: building a `torch.cuda.Stream` costs microseconds a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: Optional[torch.device] = None) -> None:
    """Validate a kernel argument: dtype, shape, contiguity, device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_ids(*checks) -> None:
    """Raise unless every index lies in its range: `checks` are (name, ids,
    limit) triples, each asking for ids in [0, limit), since a kernel that
    gathers or commits through them would reach outside its tensors. All
    bounds come to the host in one transfer."""
    checks = [c for c in checks if c[1].numel()]
    if not checks:
        return
    bounds = torch.stack([torch.stack(torch.aminmax(ids)) for _, ids, _ in checks]).tolist()
    for (name, _, limit), (lo, hi) in zip(checks, bounds):
        if lo < 0 or hi >= limit:
            raise ValueError(f"{name} has ids in [{lo}, {hi}], outside [0, {limit})")
