"""repro_torch.analysis — static analyzer of the PyTorch/CUDA port.

AST-based checks for the contracts that only fail on the card, where no
CPU test reaches them: host syncs inside code a CUDA graph captures
(HS01), the 2^24 exactness guard before the int->f32 remap (XD01), the
kernel wrappers' plain and CUDA branches and every ctypes binding against
its ``extern "C"`` signature (KP01), registry capability consistency and
frozen-config purity (RC01/RC02), a captured graph's static buffers
rebound or handed out (DA01), plus hygiene warnings (UI01/DS01/MD01/EH01).
It reads source only: it imports no torch, no jax and nothing of `repro`.
Run `python -m repro_torch.analysis --help`; the gate is
`python -m repro_torch.analysis --fail-on-findings`.
"""
from repro_torch.analysis.core import (
    Checker,
    Finding,
    all_checkers,
    analyze_paths,
    analyze_sources,
    apply_baseline,
    load_baseline,
    register_checker,
    write_baseline,
)

__all__ = [
    "Checker",
    "Finding",
    "all_checkers",
    "analyze_paths",
    "analyze_sources",
    "apply_baseline",
    "load_baseline",
    "register_checker",
    "write_baseline",
]
