"""Shared helpers of the examples' parity tests (``test_torch_examples*.py``):
load a twin under ``examples/torch/``, run a JAX example under
``examples/`` in a subprocess and read its lines, hold a loss to its
printed digits, and draw a JAX example's initial parameters.  JAX is
imported only inside the functions that need it: the rank program of
``test_torch_examples_ranks.py`` imports this module."""

from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def twin(name: str):
    """``examples/torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_example(name: str, devices: int = 1, *args: str) -> list[str]:
    """The lines ``examples/<name>.py`` prints on CPU JAX with ``devices``
    host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.splitlines()


def find(lines: list[str], pattern: str) -> re.Match:
    """The one line matching ``pattern`` (anchored at its start)."""
    hits = [m for m in map(re.compile(pattern).match, lines) if m]
    assert len(hits) == 1, (pattern, lines)
    return hits[0]


def assert_loss(got: float, printed: str) -> None:
    """``got`` rounds to ``printed``: within half a unit of its last digit,
    plus rtol 1e-5 of the reference."""
    want = float(printed)
    unit = 10.0 ** -len(printed.split(".")[1])
    assert abs(got - want) <= 0.5 * unit + RTOL * abs(want), (got, printed)


def assert_log_losses(lines: list[str], pattern: str, losses: list[float]
                      ) -> int:
    """Every logged ``(index, loss)`` line of the JAX run against the
    twin's loss stream; returns how many were checked."""
    hits = [m for m in map(re.compile(pattern).match, lines) if m]
    for m in hits:
        assert_loss(losses[int(m.group(1))], m.group(2))
    return len(hits)


def jax_dyngnn_params(**cfg):
    """The JAX example's initial parameters (``init_params`` from
    ``PRNGKey(0)``, as its Engine draws them) -> (JAX tree as numpy, the
    port's ``ParamTree``)."""
    import jax

    from repro.core import models as jm
    from repro_torch import convert

    tree = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jm.DynGNNConfig(**cfg)))
    return tree, convert.params_from_jax(tree)
