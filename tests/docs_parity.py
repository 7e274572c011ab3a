"""Shared helpers of the docs' parity tests (``test_torch_docs*.py``):
run the JAX package's example docs (``docs/*.md``) in a subprocess and
read each fence's values, and hand the port's Engines the JAX initial
parameters of the same run.

The values are ``tools/torch/check_docs.py``'s ``FENCE_VALUES``,
evaluated in the JAX docs' namespaces exactly as in the twins'.  The
port draws its initial parameters from a torch generator, the JAX
package from ``PRNGKey(seed)``: the JAX subprocess records every
``init_params`` its Engines draw, keyed by the resolved model config and
seed, and ``jax_inits`` makes the port's Engines start from them.  JAX
is imported only in the subprocess: the rank programs import this
module.

``python tests/docs_parity.py OUT.pkl DOC.md ...`` is that subprocess.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOL = {"loss": 1e-5,            # tests/test_dist_stream.py:51
       "score": 1e-4,
       # an int8 run against JAX's: ROADMAP's TM-GCN bound
       # (tests/test_torch_dist_stream.py INT8_VS_JAX)
       "int8": 1e-4}


def port_tool():
    """``tools/torch/check_docs.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_check_docs", ROOT / "tools" / "torch" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tool():
    """The reference's ``tools/check_docs.py`` as a module (imports no
    JAX itself)."""
    spec = importlib.util.spec_from_file_location(
        "jax_check_docs", ROOT / "tools" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def init_key(cfg, seed: int) -> tuple:
    """What an initial parameter draw depends on: the resolved model
    config's widths and the seed."""
    return (cfg.model, int(cfg.num_nodes), int(cfg.num_steps),
            int(cfg.feat_in), int(cfg.hidden), int(cfg.out_dim),
            int(cfg.num_layers), int(cfg.window), int(cfg.num_classes),
            int(seed))


def jax_docs(names, tmp: Path, devices: int = 8) -> dict:
    """The JAX docs ``names`` on CPU JAX with ``devices`` host devices ->
    {"values": {doc: [each fence's values]}, "inits": {init_key: the
    JAX parameter tree as numpy}}."""
    out = tmp / "jax_docs.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               TMPDIR=str(tmp))
    proc = subprocess.run([sys.executable, __file__, str(out), *names],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return pickle.loads(out.read_bytes())


@contextlib.contextmanager
def jax_inits(inits: dict):
    """While entered, every port Engine handed no ``params`` starts from
    the JAX init of its resolved run (a run the JAX docs did not make
    fails with a KeyError)."""
    from repro_torch import convert
    from repro_torch.run import workers

    orig = workers._init

    def init(rr, params):
        if params is None:
            params = convert.params_from_jax(inits[init_key(rr.cfg,
                                                            rr.seed)])
        return orig(rr, params)

    workers._init = init
    try:
        yield
    finally:
        workers._init = orig


def assert_values(got: dict, want: dict, docs) -> None:
    """The port's fence values against the JAX docs' at ``TOL``: every
    fence that ran on both sides, none that ran on one side only."""
    problems = port_tool().compare_values(
        {d: got[d] for d in docs}, {d: want[d] for d in docs}, TOL)
    assert problems == [], "\n".join(problems)


def _jax_main(out: str, *names: str) -> None:
    """Every fence of the JAX docs ``names``, one namespace a doc, from
    the repo root, recording each fence's values and every Engine's
    initial parameters; pickled to ``out``."""
    import jax

    from repro import obs
    from repro.run import workers

    tool, ref = port_tool(), jax_tool()
    inits: dict = {}
    orig = workers._init

    def init(rr):
        params, opt = orig(rr)
        inits[init_key(rr.cfg, rr.seed)] = jax.tree.map(np.asarray, params)
        return params, opt

    workers._init = init
    values = {}
    os.chdir(ROOT)
    for name in names:
        obs.configure(enabled=False)
        ns: dict = {"__name__": "__docs__"}
        values[name] = []
        for i, block in enumerate(ref.python_blocks(ROOT / "docs" / name)):
            code = compile(block, f"{name}#block{i + 1}", "exec")
            exec(code, ns)  # noqa: S102
            values[name].append(tool.fence_values(name, i, ns))
    obs.configure(enabled=False)
    Path(out).write_bytes(pickle.dumps({"values": values, "inits": inits}))


if __name__ == "__main__":
    _jax_main(*sys.argv[1:])
