"""Fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import json
import uuid

import pytest

from bench_torch.core.patchdesc import ROOT


@pytest.fixture
def temp_reference():
    """``make(spec, source)``: writes ``source`` as a reference file and
    ``spec`` as a configuration file that names it, both under one fresh
    name, which it returns.  Both files are gone when the test ends."""
    made = []

    def make(spec: dict, source: str) -> str:
        name = f"_hook_test_{uuid.uuid4().hex[:12]}"
        reference = ROOT / "reference" / f"{name}.py"
        config = ROOT / "configs" / f"{name}.json"
        made.extend((reference, config))
        reference.write_text(source)
        config.write_text(json.dumps(dict(spec, reference=name)))
        return name

    yield make
    for path in made:
        path.unlink(missing_ok=True)
