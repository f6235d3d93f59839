"""Checker registration: importing this package populates
`repro_torch.analysis.core.CHECKERS` via the `@register_checker` decorators.

Add a new checker by dropping a module here that defines a
`Checker` subclass under `@register_checker` and importing it below
(see README.md, "Static analysis: `repro_torch.analysis`").
"""
from repro_torch.analysis.checkers import (  # noqa: F401  (registration side effect)
    donation,
    exactness,
    exceptions,
    host_sync,
    hygiene,
    kernel_parity,
    registry_consistency,
)
