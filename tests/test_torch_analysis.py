"""repro_torch.analysis: every checker flags its seeded violation (in the
port's PyTorch/CUDA idiom) and passes the clean twin; suppressions and the
baseline filter findings; the codes the reference shares as pure AST
checks give the reference's findings on the same sources; the port's own
source analyzes clean (the gate's contract); and the analyzer imports no
torch, jax or repro."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import (
    analyze_paths,
    analyze_sources,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.checkers.host_sync import captured_roots
from repro_torch.analysis.checkers.kernel_parity import c_bindings, extern_c_functions
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.core import collect_files, load_modules, load_resources

REPO_ROOT = Path(__file__).resolve().parent.parent
SRC = REPO_ROOT / "src" / "repro_torch"


def run(source, select=None, path="src/repro_torch/mod.py", extra=None):
    sources = {path: textwrap.dedent(source)}
    for p, s in (extra or {}).items():
        sources[p] = textwrap.dedent(s)
    return analyze_sources(sources, select=select)


def codes(findings):
    return [f.code for f in findings]


def real_sources(*rel):
    return {f"src/repro_torch/{r}": (SRC / r).read_text() for r in rel}


# ------------------------------------------------------------------- HS01

# A fused loop in the engine's shape: `capture` captures `_chunk` through a
# bound method handed to `captured_launches`; `_chunk` calls `_step`, which
# calls `_inner` (SEED goes two calls below the captured `self._chunk`).
# `run` reads the stop flag outside the capture.
HS_LOOP = """
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.dispatch import host_flag

    def _inner(val, n: int):
        k = int(val.shape[0]) + int(n)
        SEED
        return val + k

    def _step(prog, val, n: int):
        if prog.convergence == "tol":
            val = val * 0.5
        return _inner(val, n)

    class Loop:
        def __init__(self, prog, val, n):
            self.prog, self.val, self.n = prog, val, int(n)
            self.stop = torch.zeros((), dtype=torch.bool)
            self.graph = None

        def _chunk(self):
            self.val.copy_(_step(self.prog, self.val, self.n))
            self.stop.copy_(self.val.sum() < 0)

        def capture(self):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                launches = dispatch.captured_launches(self._chunk)
            self.graph, self.launches = graph, launches

        def run(self, init):
            self.val.copy_(init)
            for _ in range(4):
                self.graph.replay()
                if bool(self.stop):
                    break
            return self.val.clone()
"""
HS_DISPATCH = """
    def captured_launches(fn):
        fn()
        return {}

    def host_flag(name):
        return (0, 0, None)
"""
HS_SEEDS = {
    "item": "val.max().item()",
    "host_flag_read": "flag = host_flag('segment_reduce')\n        bits = flag[2].value",
    "tolist": "val.tolist()",
    "cpu": "val.cpu()",
    "to_cpu": "val.to('cpu')",
    "synchronize": "torch.cuda.synchronize()",
    "nonzero": "torch.nonzero(val)",
    "np_asarray": "np.asarray(val)",
    "int_of_tensor": "int(val.sum())",
    "where_one_arg": "torch.where(val > 0)",
    "repeat_interleave": "val.repeat_interleave(val.long())",
}


def hs_run(seed):
    src = HS_LOOP.replace("SEED", seed)
    return run(src, select=["HS01"], path="src/repro_torch/graph/loop.py",
               extra={"src/repro_torch/kernels/dispatch.py": HS_DISPATCH})


@pytest.mark.parametrize("name", sorted(HS_SEEDS))
def test_hs01_flags_sync_two_calls_below_captured_chunk(name):
    fs = hs_run(HS_SEEDS[name])
    assert fs and set(codes(fs)) == {"HS01"}
    assert all(f.anchor == "_inner" for f in fs), [f.render() for f in fs]
    assert "_FusedLoop" not in fs[0].message and "Loop._chunk" in fs[0].message
    if name == "host_flag_read":
        assert any("host flag" in f.message and ".value" in f.message for f in fs)


def test_hs01_clean_twin_passes_and_run_is_not_captured():
    """Static int() of shapes and annotated ints, static `if` tests on
    program fields, and `run()`'s `bool(self.stop)` outside the capture."""
    assert hs_run("k = k + 1") == []


def test_hs01_flags_item_in_capture_block():
    src = """
        import torch

        def step(val):
            return val + 1

        def capture(val):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = step(val)
                scale = out.max().item()
            return g, scale
    """
    fs = run(src, select=["HS01"])
    assert codes(fs) == ["HS01"] and ".item()" in fs[0].message


def test_hs01_make_graphed_callables_roots():
    src = """
        import torch

        def body(x):
            return x * float(x.sum())

        def clean(x):
            return x * float(x.shape[0])

        graphed = torch.cuda.make_graphed_callables((body, clean), (None,))
    """
    fs = run(src, select=["HS01"])
    assert codes(fs) == ["HS01"] and fs[0].anchor == "body"


def test_hs01_prunes_the_cpu_branch_of_a_wrapper():
    """Captured code runs on the card: a wrapper's CPU branch (its ids'
    host check) is not captured; the same read on the CUDA path is."""
    src = """
        import torch

        def wrapper(x):
            if x.device.type == "cpu":
                return x.tolist()
            return x + 1

        def leaky(x):
            if x.device.type != "cuda":
                raise ValueError("cuda only")
            return x.tolist()

        def capture(x):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                wrapper(x)
                leaky(x)
    """
    fs = run(src, select=["HS01"])
    assert codes(fs) == ["HS01"] and fs[0].anchor == "leaky"


HS_REAL = ("graph/engine.py", "kernels/ops.py", "kernels/bsp_superstep.py",
           "kernels/dispatch.py", "graph/build.py", "launch/mesh.py", "core/metrics.py")


def test_hs01_would_have_caught_local_fixpoint_without_err():
    """The committed engine's captured chunk is clean: `_local_fixpoint`
    passes `err=plan.err`, so `ops.bsp_superstep` takes the flag path.
    The same call without `err` takes the wrapper's host read of the flag
    (`check_flag`'s `int(err)`, `check_ids`'s transfer) and must flag."""
    srcs = real_sources(*HS_REAL)
    assert analyze_sources(srcs, select=["HS01"]) == []
    eng = srcs["src/repro_torch/graph/engine.py"]
    broken = eng.replace("block_e=plan.block_e, err=plan.err, live=live,",
                         "block_e=plan.block_e, live=live,")
    assert broken != eng
    fs = analyze_sources({**srcs, "src/repro_torch/graph/engine.py": broken}, select=["HS01"])
    anchors = {f.anchor for f in fs}
    assert set(codes(fs)) == {"HS01"} and {"check_flag", "check_ids"} <= anchors
    assert all("_FusedLoop._chunk" in f.message for f in fs)


def test_hs01_finds_the_fused_loop_chunk_as_a_captured_root():
    files = collect_files([SRC], root=REPO_ROOT)
    roots = captured_roots(load_modules(files, rel_root=REPO_ROOT))
    assert "repro_torch.graph.engine._FusedLoop._chunk" in roots
    assert "repro_torch.kernels.dispatch.captured_launches" in roots


# ------------------------------------------------------------------- XD01


XD_PRELUDE = """
    import torch

    INF_I32 = 2**31 - 1
    INF_F32 = 3.0e38

    def _remap(val):
        return torch.where(val == INF_I32, INF_F32, val.to(torch.float32))

    def _check_ids(val):
        if int(val.max()) >= 1 << 24:
            raise ValueError("ids exceed the f32-exact domain")
"""

XD_BAD_DIRECT = XD_PRELUDE + """
    def run_kernel(val):
        return _remap(val)
"""

XD_BAD_CLOSURE = XD_PRELUDE + """
    def make_stepper(statics):
        def stepper(v):
            return _remap(v)
        return stepper
"""

XD_BAD_METHOD = XD_PRELUDE + """
    class Runner:
        def _prepare(self, val):
            return _remap(val)

        def run(self, val):
            return self._prepare(val)
"""

XD_CLEAN_GUARDED = XD_PRELUDE + """
    def run_kernel(val):
        _check_ids(val)
        return _remap(val)

    def make_stepper(statics):
        def stepper(v):
            return _remap(v)
        def runner(v):
            _check_ids(v)
            return stepper(v)
        return runner

    class Runner:
        def _prepare(self, val):
            _check_ids(val)
            return _remap(val)

        def run(self, val):
            return self._prepare(val)
"""


def test_xd01_flags_unguarded_entry():
    fs = run(XD_BAD_DIRECT, select=["XD01"])
    assert codes(fs) == ["XD01"]
    assert fs[0].anchor == "run_kernel"


def test_xd01_flags_unguarded_closure():
    fs = run(XD_BAD_CLOSURE, select=["XD01"])
    assert codes(fs) == ["XD01"]
    assert fs[0].anchor == "make_stepper"


def test_xd01_flags_unguarded_method_through_self():
    fs = run(XD_BAD_METHOD, select=["XD01"])
    assert codes(fs) == ["XD01"]
    assert fs[0].anchor == "Runner.run"


def test_xd01_guarded_twin_passes():
    assert run(XD_CLEAN_GUARDED, select=["XD01"]) == []


def test_xd01_would_have_caught_an_unguarded_exec_entry():
    """The committed engine analyzes clean; taking the value-boundary guard
    (`_kernel_value_boundary`) out of `_to_exec` leaves `kernel_inputs`
    (and `BatchExecutable.run`, through `self.*`) reaching `_to_f32` unguarded."""
    srcs = real_sources("graph/engine.py")
    assert analyze_sources(srcs, select=["XD01"]) == []
    eng = srcs["src/repro_torch/graph/engine.py"]
    broken = eng.replace("    val, codec = _kernel_value_boundary(prog, sub, val)\n",
                         "    codec = None\n")
    assert broken != eng
    fs = analyze_sources({"src/repro_torch/graph/engine.py": broken}, select=["XD01"])
    anchors = {f.anchor for f in fs}
    assert set(codes(fs)) == {"XD01"} and "kernel_inputs" in anchors
    assert "BatchExecutable.run" in anchors


# ------------------------------------------------------------------- KP01

KP_CU = """
    #include <cuda_runtime.h>

    __global__ void thing_kernel(const float* x, float* out, int n) {}

    extern "C" {

    // the workspace a call needs
    long long thing_workspace(int n, int p) { return 4LL * n * p; }

    int thing_host_flag(void** host, void** dev) { return 0; }

    int thing_launch(const void* x, void* out, void* ws, long long n, int p, float scale,
                     void* stream) {
      if (n < 1) return 1;
      thing_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<float*>(out), (int)n);
      return (int)cudaGetLastError();
    }

    }  // extern "C"
"""

KP_DISPATCH = """
    import collections
    import ctypes

    LAUNCHES = collections.Counter()

    def c_function(name, symbol, argtypes, restype=ctypes.c_int):
        return None

    def check_launch(name, err):
        if err != 0:
            raise RuntimeError(name)

    def host_flag(name):
        fn = c_function(name, f"{name}_host_flag", [ctypes.c_void_p] * 2)
        check_launch(f"{name}_host_flag", fn(None, None))
        return (0, 0, None)
"""

KP_WRAPPER = """
    import ctypes

    import torch

    from repro_torch.kernels.dispatch import LAUNCHES, c_function, check_launch, host_flag

    def thing_plain(x, p: int, *, scale: float = 1.0):
        return x * scale

    def _launch(x, p, scale):
        ws_n = c_function("thing", "thing_workspace", [ctypes.c_int] * 2,
                          restype=ctypes.c_longlong)(x.shape[0], p)
        out = torch.empty_like(x)
        ws = torch.empty((ws_n,), device=x.device)
        flag = host_flag("thing")
        fn = c_function("thing", "thing_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
                        + [ctypes.c_void_p])
        err = fn(x.data_ptr(), out.data_ptr(), ws.data_ptr(), x.shape[0], p, scale, None)
        check_launch("thing", err)
        LAUNCHES["thing"] += 1
        return out

    def thing(x, p: int, *, scale: float = 1.0):
        if x.device.type == "cpu":
            return thing_plain(x, p, scale=scale)
        return _launch(x, p, scale)
"""

KP_OPS = """
    from repro_torch.kernels import thing as _thing

    def pad_stream(x, *, block_e):
        return x

    def thing(x, p, *, scale=1.0, block_e=512):
        del block_e
        return _thing.thing(x, p, scale=scale)

    def thing_padded(x, p, *, block_e=512):
        return _thing.thing(pad_stream(x, block_e=block_e), p)

    def helper(x):
        return x
"""


def kp_sources(wrapper=KP_WRAPPER, ops=KP_OPS, cu=KP_CU, dispatch=KP_DISPATCH):
    return {
        "src/repro_torch/kernels/ops.py": textwrap.dedent(ops),
        "src/repro_torch/kernels/thing.py": textwrap.dedent(wrapper),
        "src/repro_torch/kernels/dispatch.py": textwrap.dedent(dispatch),
        "src/repro_torch/kernels/csrc/thing.cu": textwrap.dedent(cu),
    }


def kp_run(**kw):
    return analyze_sources(kp_sources(**kw), select=["KP01"])


def test_kp01_clean_wrapper_passes():
    assert kp_run() == []
    bindings = {(b.lib, b.symbol): (b.argtypes, b.c_arity)
                for b in c_bindings(load_sources(kp_sources()), kp_sources())}
    assert bindings == {
        ("thing", "thing_workspace"): (("c_int", "c_int"), 2),
        ("thing", "thing_host_flag"): (("c_void_p", "c_void_p"), 2),
        ("thing", "thing_launch"): (("c_void_p",) * 3 + ("c_longlong", "c_int", "c_float",
                                                         "c_void_p"), 7),
    }


def load_sources(sources):
    from repro_torch.analysis.core import Module

    return [Module.from_source(p, s) for p, s in sources.items() if p.endswith(".py")]


KP_BINDING_DRIFT = {
    "dropped_argtype": ("[ctypes.c_void_p] * 3 + [ctypes.c_longlong", "[ctypes.c_void_p] * 2 + "
                        "[ctypes.c_longlong", "binds 6 argtypes"),
    "int_to_float": ("[ctypes.c_longlong, ctypes.c_int, ctypes.c_float]",
                     "[ctypes.c_longlong, ctypes.c_float, ctypes.c_float]",
                     "argument 4 (`int p`)"),
    "misspelt_symbol": ('"thing", "thing_launch"', '"thing", "thing_lanuch"',
                        "not an extern \"C\" function"),
    "restype": ("restype=ctypes.c_longlong", "restype=ctypes.c_int", "returns `c_longlong`"),
}


@pytest.mark.parametrize("name", sorted(KP_BINDING_DRIFT))
def test_kp01_flags_binding_drift_against_the_c_source(name):
    old, new, needle = KP_BINDING_DRIFT[name]
    wrapper = textwrap.dedent(KP_WRAPPER)
    assert old in wrapper
    fs = kp_run(wrapper=wrapper.replace(old, new))
    assert codes(fs) == ["KP01"], [f.render() for f in fs]
    assert needle in fs[0].message and fs[0].path.endswith("kernels/thing.py")


def test_kp01_checks_host_flag_per_literal_caller():
    """`host_flag(name)`'s f-string symbol is checked at its literal call
    sites: a library without `<name>_host_flag` is flagged; a non-literal
    caller cannot be checked and is flagged too."""
    fs = kp_run(cu=KP_CU.replace("int thing_host_flag(", "int thing_hostflag("))
    assert codes(fs) == ["KP01"] and "thing_host_flag" in fs[0].message
    assert "through `src/repro_torch/kernels/thing.py" in fs[0].message
    fs = kp_run(wrapper=KP_WRAPPER.replace('host_flag("thing")', "host_flag(x.name)"))
    assert codes(fs) == ["KP01"] and "non-literal" in fs[0].message


def test_kp01_flags_unfoldable_argtypes():
    fs = kp_run(wrapper=KP_WRAPPER.replace("[ctypes.c_int] * 2,", "ARGTYPES,"))
    assert codes(fs) == ["KP01"] and "do not fold" in fs[0].message


KP_CONTRACT_DRIFT = {
    "no_plain_branch": ('    if x.device.type == "cpu":\n        return thing_plain(x, p, scale=scale)\n',
                        "", "no CPU branch"),
    "plain_signature": ("thing_plain(x, p, scale=scale)", "thing_plain(x, scale=scale)",
                        "misses required parameter(s) ['p']"),
    "no_launch_count": ('    LAUNCHES["thing"] += 1\n', "", "counts no launch"),
    "unchecked_code": ('    check_launch("thing", err)\n', "", "never reaches check_launch"),
    "quiet_fallback": ("    return _launch(x, p, scale)",
                       "    try:\n        return _launch(x, p, scale)\n"
                       "    except RuntimeError:\n        return thing_plain(x, p)",
                       "falls back to the plain version"),
}


@pytest.mark.parametrize("name", sorted(KP_CONTRACT_DRIFT))
def test_kp01_flags_wrapper_contract_drift(name):
    old, new, needle = KP_CONTRACT_DRIFT[name]
    wrapper = textwrap.dedent(KP_WRAPPER)
    assert old in wrapper
    fs = kp_run(wrapper=wrapper.replace(old, new))
    assert "KP01" in codes(fs) and any(needle in f.message for f in fs), [
        f.render() for f in fs]


def test_kp01_flags_unpadded_block_param():
    ops = KP_OPS.replace("        del block_e\n", "")
    fs = kp_run(ops=ops)
    assert codes(fs) == ["KP01"] and fs[0].anchor == "thing" and "block_e" in fs[0].message


def test_kp01_real_kernels_pass_with_every_binding_covered():
    """The committed wrappers and csrc/ analyze clean, and all 13
    c_function sites are held against the six extern "C" blocks: 12
    literal sites and dispatch.host_flag once per literal caller."""
    files = collect_files([SRC / "kernels"], root=REPO_ROOT)
    modules = load_modules(files, rel_root=REPO_ROOT)
    resources = load_resources(files, rel_root=REPO_ROOT)
    assert sorted(Path(p).name for p in resources) == [
        "bsp_superstep.cu", "decode_attn.cu", "decode_attn_wide.cu", "ebg_commit.cu",
        "ebg_membership.cu", "segment_reduce.cu"]
    assert analyze_paths([SRC / "kernels"], root=REPO_ROOT, select=["KP01"]) == []
    # One wrapper alone: the C sources beside it are read with it.
    assert analyze_paths([SRC / "kernels/segment_reduce.py", SRC / "kernels/dispatch.py"],
                         root=REPO_ROOT, select=["KP01"]) == []
    bindings = c_bindings(modules, resources)
    assert len({(b.path, b.line) for b in bindings}) == 13
    assert all(b.c_arity == len(b.argtypes) for b in bindings)
    pairs = {(b.lib, b.symbol) for b in bindings}
    assert len(pairs) == 14
    assert {("segment_reduce", "segment_reduce_host_flag"),
            ("ebg_membership", "ebg_membership_host_flag")} <= pairs
    launch = extern_c_functions((SRC / "kernels/csrc/bsp_superstep.cu").read_text())
    assert len(launch["bsp_superstep_launch"].params) == 19
    assert launch["bsp_superstep_scratch_bytes"].restype == "c_longlong"


def test_kp01_would_have_caught_an_undeclared_block_param():
    """The committed `ops` analyzes clean; `segment_min_plus` without its
    `del block_e` neither pads, forwards nor drops the TPU block: flagged."""
    files = collect_files([SRC / "kernels"], root=REPO_ROOT)
    srcs = {m.path: m.source for m in load_modules(files, rel_root=REPO_ROOT)}
    srcs.update(load_resources(files, rel_root=REPO_ROOT))
    ops = srcs["src/repro_torch/kernels/ops.py"]
    broken = ops.replace('    the TPU grid\'s edge block: the kernel takes any E, so nothing is padded."""\n'
                         "    del block_e\n",
                         '    the TPU grid\'s edge block: the kernel takes any E, so nothing is padded."""\n')
    assert broken != ops
    fs = analyze_sources({**srcs, "src/repro_torch/kernels/ops.py": broken}, select=["KP01"])
    assert codes(fs) == ["KP01"]
    assert fs[0].anchor == "segment_min_plus" and "block_e" in fs[0].message


# ------------------------------------------------------------- RC01 / RC02


RC_PARTITIONER_BAD = """
    from repro_torch.api.registry import register_partitioner

    @register_partitioner("demo", chunked=True)
    def demo_partition(graph, num_parts, *, device=None):
        return None

    @register_partitioner("demo2")
    def demo2_partition(graph, num_parts, *, block=64):
        return None

    @register_partitioner("demo3", scorer="nope")
    def demo3_partition(graph, num_parts, *, compute_backend="xla", device=None):
        return None
"""

RC_SCORERS = """
    from repro_torch.core.streaming import EdgeScorer

    EBV = EdgeScorer(name="ebv", ce=1.0, cv=1.0)
"""

RC_PARTITIONER_CLEAN = """
    from repro_torch.api.registry import register_partitioner

    @register_partitioner("demo", chunked=True, scorer="ebv")
    def demo_partition(graph, num_parts, *, block=64, device=None):
        return None
"""

RC_PROGRAM_BAD = """
    from repro_torch.graph.engine import VertexProgram, register_program

    SUMFIX = register_program(VertexProgram(name="sumfix", dtype="int32", combine="sum"))
    TYPO = register_program(VertexProgram(name="typo", dtype="int16"))
    DUP = register_program(VertexProgram(name="sumfix", dtype="int32"))
"""

RC_PROGRAM_CLEAN = """
    from repro_torch.graph.engine import VertexProgram, register_program

    OK = register_program(VertexProgram(
        name="ok", dtype="float32", combine="sum", local="sweep", apply="pagerank",
    ))
"""

RC02_BAD = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Config:
        blocks: list = []

        def __post_init__(self):
            object.__setattr__(self, "blocks", list(self.blocks))
"""

RC02_CLEAN = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Config:
        blocks: tuple = ()

        def __post_init__(self):
            if not all(b > 0 for b in self.blocks):
                raise ValueError("blocks must be positive")
"""


def test_rc01_flags_capability_mismatches():
    fs = run(RC_PARTITIONER_BAD, select=["RC01"],
             extra={"src/repro_torch/core/scorers.py": RC_SCORERS})
    msgs = [(f.anchor, f.message) for f in fs]
    assert codes(fs) == ["RC01"] * 5, msgs
    assert any(a == "demo_partition" and "takes no `block`" in m for a, m in msgs)
    assert any(a == "demo2_partition" and "no `device` keyword" in m for a, m in msgs)
    assert any(a == "demo2_partition" and "not declared chunked=True" in m for a, m in msgs)
    assert any(a == "demo3_partition" and "compute_backend" in m for a, m in msgs)
    assert any(a == "demo3_partition" and "scorer='nope'" in m for a, m in msgs)


def test_rc01_partitioner_clean_twin_passes():
    assert run(RC_PARTITIONER_CLEAN, select=["RC01"],
               extra={"src/repro_torch/core/scorers.py": RC_SCORERS}) == []


def test_rc01_flags_program_field_violations():
    msgs = " | ".join(f.message for f in run(RC_PROGRAM_BAD, select=["RC01"]))
    assert "combine='sum' requires local='sweep'" in msgs
    assert "int16" in msgs
    assert "already registered" in msgs


def test_rc01_program_clean_twin_passes():
    assert run(RC_PROGRAM_CLEAN, select=["RC01"]) == []


def test_rc01_real_registry_passes():
    """The port's nine partitioners and five programs are consistent."""
    srcs = {m.path: m.source for m in load_modules(
        collect_files([SRC / "core", SRC / "graph", SRC / "api"], root=REPO_ROOT),
        rel_root=REPO_ROOT)}
    assert analyze_sources(srcs, select=["RC01"]) == []
    broken = srcs["src/repro_torch/core/streaming.py"].replace(
        'chunked=True, scorer="hdrf"', 'chunked=True, scorer="hdfr"')
    fs = analyze_sources({**srcs, "src/repro_torch/core/streaming.py": broken}, select=["RC01"])
    assert codes(fs) == ["RC01"] and fs[0].anchor == "hdrf_partition"


def test_rc02_flags_mutable_default_and_setattr():
    fs = run(RC02_BAD, select=["RC02"])
    assert codes(fs) == ["RC02", "RC02"]


def test_rc02_clean_twin_passes():
    assert run(RC02_CLEAN, select=["RC02"]) == []


# ------------------------------------------------------------------- DA01


DA_LOOP = """
    import torch

    class Loop:
        def __init__(self, n):
            self.val = torch.zeros(n)
            self.stop = torch.zeros((), dtype=torch.bool)
            self.graph = None
            self.launches = None

        def _chunk(self):
            self.val.mul_(0.5)
            self.stop.copy_(self.val.sum() < 1)

        def capture(self):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._chunk()
            self.graph, self.launches = graph, {}

        def run(self, init):
            self.val.copy_(init)
            self.stop.zero_()
            self.graph.replay()
            return self.val.clone()
"""


def test_da01_flags_rebind_after_capture():
    src = DA_LOOP.replace("            self.val.copy_(init)\n", "            self.val = init\n")
    fs = run(src, select=["DA01"])
    assert codes(fs) == ["DA01"] and "`self.val` is rebound in `Loop.run`" in fs[0].message


def test_da01_flags_uncloned_return():
    src = DA_LOOP.replace("return self.val.clone()", "return self.val, self.stop")
    fs = run(src, select=["DA01"])
    assert codes(fs) == ["DA01", "DA01"]
    assert "returns `self.val`" in fs[0].message and "returns `self.stop`" in fs[1].message


def test_da01_in_place_writes_and_clone_pass():
    assert run(DA_LOOP, select=["DA01"]) == []


def test_da01_would_have_caught_the_fused_loop_returning_its_buffer():
    srcs = real_sources("graph/engine.py", "kernels/dispatch.py")
    assert analyze_sources(srcs, select=["DA01"]) == []
    eng = srcs["src/repro_torch/graph/engine.py"]
    broken = eng.replace("return self.val.clone(), steps_q,", "return self.val, steps_q,")
    assert broken != eng
    fs = analyze_sources({**srcs, "src/repro_torch/graph/engine.py": broken}, select=["DA01"])
    assert codes(fs) == ["DA01"] and fs[0].anchor == "_FusedLoop.run.val"


# ----------------------------------------------------------------- hygiene


def test_ui01_flags_unused_import_and_honors_noqa():
    bad = """
        import os
        import sys

        print(sys.argv)
    """
    fs = run(bad, select=["UI01"])
    assert codes(fs) == ["UI01"] and fs[0].anchor == "os"
    assert run(bad.replace("import os", "import os  # noqa"), select=["UI01"]) == []


def test_ds01_flags_dead_store():
    bad = """
        def f(x):
            unused = x * 2
            return x
    """
    fs = run(bad, select=["DS01"])
    assert codes(fs) == ["DS01"]
    assert run(bad.replace("return x", "return unused"), select=["DS01"]) == []


def test_md01_flags_mutable_default():
    assert codes(run("def f(x, acc=[]):\n    return acc\n", select=["MD01"])) == ["MD01"]
    assert run("def f(x, acc=()):\n    return acc\n", select=["MD01"]) == []


# ------------------------------------------------------------------- EH01


EH_BAD_PASS = """
    def load(path):
        try:
            return open(path).read()
        except Exception:
            pass
"""

EH_BAD_BARE = """
    def load(path):
        try:
            return open(path).read()
        except:
            ...
"""

EH_BAD_TUPLE = """
    def load(path):
        try:
            return open(path).read()
        except (ValueError, BaseException):
            pass
"""

EH_CLEAN_SPECIFIC = """
    def load(path):
        try:
            return open(path).read()
        except FileNotFoundError:
            pass
"""

EH_CLEAN_HANDLED = """
    import logging

    def load(path):
        try:
            return open(path).read()
        except Exception as e:
            logging.warning("load failed: %s", e)
            return None
"""


def test_eh01_flags_swallowed_broad_handlers():
    for src in (EH_BAD_PASS, EH_BAD_BARE, EH_BAD_TUPLE):
        fs = run(src, select=["EH01"])
        assert codes(fs) == ["EH01"], src
        assert fs[0].severity == "warning"
        assert "swallows" in fs[0].message


def test_eh01_allows_specific_or_handled():
    assert run(EH_CLEAN_SPECIFIC, select=["EH01"]) == []
    assert run(EH_CLEAN_HANDLED, select=["EH01"]) == []


def test_eh01_honors_noqa():
    src = EH_BAD_PASS.replace("except Exception:", "except Exception:  # noqa")
    assert run(src, select=["EH01"]) == []


# ---------------------------------- parity with the reference (AST-only codes)

HYGIENE_BAD = """
    import os
    import sys
    from collections import OrderedDict

    def f(x, acc=[], *, seen={}):
        unused = x * 2
        first, _ = x, 1
        return acc

    def load(path):
        try:
            return open(path).read()
        except Exception:
            pass

    print(sys.argv)
"""

PARITY_CASES = {
    "UI01": HYGIENE_BAD,
    "DS01": HYGIENE_BAD,
    "MD01": HYGIENE_BAD,
    "EH01": HYGIENE_BAD + EH_BAD_BARE + EH_BAD_TUPLE,
    "RC02": RC02_BAD + RC02_CLEAN.replace("class Config", "class Clean"),
    "line_suppression": HYGIENE_BAD.replace("import os", "import os  # repro: ignore[UI01]")
    .replace("unused = x * 2", "unused = x * 2  # repro: ignore[MD01]"),
    "bare_suppression": HYGIENE_BAD.replace("import os", "import os  # repro: ignore"),
    "file_suppression": "# repro: ignore-file[DS01, MD01]\n" + textwrap.dedent(HYGIENE_BAD),
}


def _tuples(findings):
    return [(f.code, f.line, f.col, f.message, f.severity, f.anchor) for f in findings]


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_ast_only_codes_match_the_reference(case):
    """The same seeded source through the reference's analyzer and the
    port's (only the suppression marker rewritten) gives the same findings."""
    src = textwrap.dedent(PARITY_CASES[case])
    select = ["UI01", "DS01", "MD01", "EH01", "RC02"]
    want = ref_analysis.analyze_sources({"src/repro/mod.py": src}, select=select)
    got = analyze_sources({"src/repro_torch/mod.py": src.replace("# repro:", "# repro_torch:")},
                          select=select)
    assert want and _tuples(got) == _tuples(want)
    if "suppression" in case:
        unsuppressed = analyze_sources({"src/repro_torch/mod.py": src}, select=select)
        assert len(unsuppressed) > len(got)


def test_baseline_and_fingerprints_match_the_reference(tmp_path):
    src = textwrap.dedent(HYGIENE_BAD)
    want = ref_analysis.analyze_sources({"src/repro/mod.py": src})
    got = analyze_sources({"src/repro/mod.py": src}, select=[f.code for f in want])
    assert [f.fingerprint for f in got] == [f.fingerprint for f in want]
    ref_analysis.write_baseline(want, tmp_path / "ref.json")
    write_baseline(got, tmp_path / "port.json")
    assert (tmp_path / "ref.json").read_text() == (tmp_path / "port.json").read_text()
    assert apply_baseline(got, load_baseline(tmp_path / "ref.json")) == []


# -------------------------------------------------- suppressions, baseline

HS_BAD = HS_SEEDS["item"]


def test_line_suppression_by_code():
    seed = HS_BAD + "  # repro_torch: ignore[HS01]  the loop's own test read"
    assert hs_run(seed) == []
    wrong = HS_BAD + "  # repro_torch: ignore[XD01]"
    assert codes(hs_run(wrong)) == ["HS01"]
    assert codes(hs_run(HS_BAD + "  # repro: ignore[HS01]")) == ["HS01"]  # the reference's marker


def test_bare_line_suppression_covers_all_codes():
    assert hs_run(HS_BAD + "  # repro_torch: ignore") == []


def test_file_suppression():
    src = "# repro_torch: ignore-file[HS01]\n" + textwrap.dedent(HS_LOOP.replace("SEED", HS_BAD))
    assert analyze_sources({"src/repro_torch/graph/loop.py": src,
                            "src/repro_torch/kernels/dispatch.py": textwrap.dedent(HS_DISPATCH)},
                           select=["HS01"]) == []


def test_baseline_roundtrip(tmp_path):
    fs = hs_run(HS_BAD)
    assert fs
    path = tmp_path / "baseline.json"
    write_baseline(fs, path)
    baseline = load_baseline(path)
    assert apply_baseline(fs, baseline) == []
    assert load_baseline(tmp_path / "missing.json") == set()


def test_fingerprint_is_line_number_free():
    fs1 = hs_run(HS_BAD)
    fs2 = hs_run(HS_BAD.replace("val.max()", "\n        val.max()"))
    assert fs1[0].line != fs2[0].line
    assert fs1[0].fingerprint == fs2[0].fingerprint


# ---------------------------------------------------------------- CLI gate

CLI_BAD = ("import torch\n\ndef f(x):\n    return float(x)\n\n"
           "def capture(x):\n    with torch.cuda.graph(torch.cuda.CUDAGraph()):\n        f(x)\n")


def test_cli_fail_on_findings_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(CLI_BAD)
    assert cli_main([str(bad), "--fail-on-findings", "--baseline", str(tmp_path / "b.json")]) == 1
    report = tmp_path / "report.json"
    assert cli_main([str(bad), "--json", str(report), "--baseline", str(tmp_path / "b.json")]) == 0
    payload = json.loads(report.read_text())
    assert [f["code"] for f in payload["findings"]] == ["HS01"]
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n")
    assert cli_main([str(clean), "--fail-on-findings"]) == 0
    capsys.readouterr()


def test_cli_baseline_accepts_known_findings(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(CLI_BAD)
    baseline = tmp_path / "baseline.json"
    assert cli_main([str(bad), "--baseline", str(baseline), "--write-baseline"]) == 0
    assert cli_main([str(bad), "--baseline", str(baseline), "--fail-on-findings"]) == 0
    capsys.readouterr()


def test_cli_lists_every_checker(capsys):
    assert cli_main(["--list-checkers"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(["HS01", "XD01", "KP01", "RC01", "RC02", "DA01", "UI01", "DS01",
                             "MD01", "EH01"])


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src")
    return env


def test_gate_exits_zero_over_the_port():
    """`python -m repro_torch.analysis --fail-on-findings` over
    src/repro_torch, with the committed (empty) baseline, exits 0."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--fail-on-findings"],
                          cwd=REPO_ROOT, env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s), 0 warning(s)" in proc.stdout


def test_analyzer_imports_no_torch_jax_or_repro():
    code = ("import sys\nimport repro_torch.analysis\n"
            "from repro_torch.analysis import all_checkers\nall_checkers()\n"
            "import repro_torch.analysis.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=_clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------ repo is clean


def test_repo_analyzes_clean_with_empty_baseline():
    """The gate's contract: the committed baseline is EMPTY and the whole
    port still analyzes clean — findings get fixed, not filed."""
    baseline_path = REPO_ROOT / "analysis_baseline_torch.json"
    assert baseline_path.exists() and load_baseline(baseline_path) == set()
    findings = analyze_paths([SRC], root=REPO_ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)


# ---------------------------------------------------- the legacy import path


def test_core_ebg_reexports_the_streaming_entries():
    from repro_torch.core import ebg, streaming

    assert ebg.ebg_partition is streaming.ebg_partition
    assert ebg.ebg_partition_chunked is streaming.ebg_partition_chunked
    assert ebg.__all__ == ["ebg_partition", "ebg_partition_chunked"]
