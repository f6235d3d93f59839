"""Port parity, the example twins: `examples/*_torch.py` against the
reference's `examples/*.py` and launchers, on the CPU.

- quickstart and expert placement: the twin's stdout, run as a script
  (`runpy`, `__name__ == "__main__"`) with `--device cpu` where it takes a
  device, equals the reference example's stdout letter for letter.
- serve_lm: the reference's `init_params(cfg, PRNGKey(0), f32)` carried
  across (`interop.lm_params_from_numpy`) in place of the port's seeded
  init; the twin's tokens equal the reference `serve.main`'s at the
  example's flags wherever the reference's top-2 logit margin exceeds the
  serve tolerance (logits 1e-3 over bf16 caches, as `test_torch_lm.py`).
- train_lm: the same weights carried across at `--steps 40`; the first
  five losses equal the reference `train.main`'s with the same flags (and
  a checkpoint directory of its own) to 1e-3; the loss drops; a rerun on
  the same directory exits with the twin's message.
- without a card and without `--device cpu` the device twins raise;
  no twin imports `jax` or `repro`.
"""
import ast
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import steps as ref_steps
from repro.models import transformer as ref_T
from repro_torch import configs, interop
from repro_torch.launch import serve, train

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart", "serve_lm", "train_lm", "expert_placement")
DEVICE_TWINS = ("quickstart", "serve_lm", "train_lm")
SERVE_ATOL = 1e-3
TRAIN_LOSS_ATOL = 1e-3


def _twin(name):
    return EXAMPLES / f"{name}_torch.py"


def _run_script(path, monkeypatch, *args):
    """Run an example as `python path args...` does, in this process."""
    monkeypatch.setattr(sys, "argv", [str(path), *args])
    runpy.run_path(str(path), run_name="__main__")


def _twin_main(name):
    return runpy.run_path(str(_twin(name)))["main"]


def _ref_params(ref_cfg, cfg):
    rp = jax.tree.map(np.asarray, ref_T.init_params(ref_cfg, jax.random.PRNGKey(0),
                                                    jnp.float32))
    return lambda *_: interop.lm_params_from_numpy(cfg, rp, device="cpu"), rp


@pytest.mark.parametrize("name,args,pinned", [
    ("quickstart", ("--device", "cpu"), "QUICKSTART_LINES"),
    ("expert_placement", (), "PLACEMENT_LINES"),
])
def test_twin_prints_the_reference_lines(name, args, pinned, capsys, monkeypatch):
    """Also: the lines chip_smoke.py holds the twin to on the card are the
    reference's."""
    runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]()
    want = capsys.readouterr().out
    _run_script(_twin(name), monkeypatch, *args)
    got = capsys.readouterr().out
    assert got == want
    assert len(want.splitlines()) >= 3
    lines = runpy.run_path(str(EXAMPLES.parent / "chip_smoke.py"))[pinned]
    assert len(lines) == 2 and set(lines) <= set(want.splitlines())


def _ref_logits(ref_cfg, rp, prompt, max_new, max_seq):
    """The reference's `generate` loop, keeping each step's logits
    [B, max_new + 1, vocab]."""
    prefill = jax.jit(ref_steps.make_prefill_step(ref_cfg, max_seq))
    step = jax.jit(ref_steps.make_serve_step(ref_cfg))
    logits, caches = prefill(rp, dict(tokens=jnp.asarray(prompt, jnp.int32)))
    S0, out = prompt.shape[1], [np.asarray(logits)]
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for t in range(max_new):
        logits, caches = step(rp, caches, dict(token=tok, pos=jnp.int32(S0 + t)))
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    return np.stack(out, axis=1)


def test_serve_twin_gives_the_reference_tokens(monkeypatch, capsys):
    """The example's flags (qwen3_4b reduced, 24 tokens, batch 4): row by
    row, logits within SERVE_ATOL and tokens equal until a step whose
    reference top-2 margin is within it."""
    arch, tokens = "qwen3_4b", 24
    ref_cfg, cfg = ref_configs.reduced_config(arch), configs.reduced_config(arch)
    init, rp = _ref_params(ref_cfg, cfg)
    monkeypatch.setattr(serve, "init_params", init)
    seen = {}
    generate = serve.generate

    def spy(cfg_, params, prompt, max_new, max_seq, **kw):
        seen["prompt"] = np.asarray(prompt)
        return generate(cfg_, params, prompt, max_new, max_seq,
                        on_step=lambda t, lg: seen.__setitem__(t, lg.clone()))

    monkeypatch.setattr(serve, "generate", spy)
    got = _twin_main("serve_lm")(["--device", "cpu"]).numpy()
    want = np.asarray(ref_serve.main(["--arch", arch, "--tokens", str(tokens), "--batch", "4"]))
    assert "generated 96 tokens" in capsys.readouterr().out
    assert got.shape == want.shape == (4, tokens)
    want_logits = _ref_logits(ref_cfg, rp, seen["prompt"], tokens, 16 + tokens)[:, :tokens]
    np.testing.assert_array_equal(want, want_logits.argmax(-1))
    got_logits = torch.stack([seen[t] for t in range(tokens)], dim=1).numpy()
    top = np.sort(want_logits, axis=-1)[..., -2:]
    margin = top[..., 1] - top[..., 0]
    for b in range(want.shape[0]):
        for t in range(tokens):
            np.testing.assert_allclose(got_logits[b, t], want_logits[b, t], rtol=0,
                                       atol=SERVE_ATOL)
            if got[b, t] != want[b, t]:
                assert margin[b, t] <= SERVE_ATOL, (b, t, margin[b, t])
                break
            if margin[b, t] <= SERVE_ATOL:
                break


def test_train_twin_follows_the_reference_and_refuses_a_finished_dir(tmp_path, monkeypatch,
                                                                     capsys):
    ref_cfg, cfg = ref_train.preset_config("tiny"), train.preset_config("tiny")
    init, _ = _ref_params(ref_cfg, cfg)
    monkeypatch.setattr(train, "init_params", init)
    want = ref_train.main(["--preset", "tiny", "--steps", "40", "--ckpt-dir",
                           str(tmp_path / "ref"), "--ckpt-every", "100", "--resume"])
    ckpt_dir = tmp_path / "port"
    main = _twin_main("train_lm")
    got = main(["--device", "cpu", "--steps", "40", "--ckpt-dir", str(ckpt_dir)])
    assert len(got) == len(want) == 40 and np.isfinite(got).all()
    np.testing.assert_allclose(got[:5], want[:5], rtol=0, atol=TRAIN_LOSS_ATOL)
    out = capsys.readouterr().out
    assert "loss drop over run" in out and got[0] > np.mean(got[-10:])
    with pytest.raises(SystemExit, match=f"{ckpt_dir} already holds step 40 of 40"):
        main(["--device", "cpu", "--steps", "40", "--ckpt-dir", str(ckpt_dir)])


@pytest.mark.parametrize("name", DEVICE_TWINS)
def test_device_twin_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_script(_twin(name), monkeypatch)


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse(_twin(name).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots, roots
    assert roots <= {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names), roots
