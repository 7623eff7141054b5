"""The port's four examples (``examples/torch_*.py``) on the CPU.

* Each runs in a subprocess with ``--device cpu`` at tiny flags and a
  timeout, exits with 0 and prints its closing line.
* The quickstart's one MUL and its 500-repeat statistics equal the
  reference quickstart's (``engine.sc_multiply`` under
  ``jax.random.PRNGKey(0)`` and its 500 split keys): every MUL's estimate
  bit for bit, except a MUL holding a cell whose uniform lies between
  the two packages' float32 survival probabilities (XLA and ATen round
  ``exp`` differently for some pulses; ``tests/test_torch_cell_model.py``),
  which may differ by its band cells; the mean and sigma within 1e-6
  (another summation order) plus what such cells can move.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import conversion as jconv
from repro.core import engine as jeng
from repro_torch.core import engine as teng
from repro_torch.sc import ctr_rng
from test_torch_cell_model import _pulse_probs, _ulp_band

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

# (example, tiny flags, a line its run must print)
RUNS = {
    "torch_quickstart": ([], "done on cpu."),
    "torch_serve_batch": (
        ["--requests", "3", "--slots", "2", "--max-new", "4", "--paged",
         "--sc", "--sc-backend", "pallas_moment"], "served 3 requests"),
    "torch_train_sc_lm": (
        ["--d-model", "64", "--layers", "1", "--d-ff", "128", "--vocab",
         "256", "--seq", "16", "--batch", "2", "--steps", "8"],
        "SC loss penalty at end"),
    "torch_fault_tolerance_demo": ([], "BIT-IDENTICAL"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name):
    flags, line = RUNS[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}.py"), "--device", "cpu",
         *flags],
        capture_output=True, text=True, env=env, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert line in proc.stdout, proc.stdout[-2000:]


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", EXAMPLES / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_mul_and_repeats_equal_the_reference():
    qs = _quickstart()
    x, y, n = qs.X_INT, qs.Y_INT, qs.REPEATS
    jcfg, tcfg = jeng.EngineConfig(nbit=1024), teng.EngineConfig(nbit=1024)
    jkey, tkey = jax.random.PRNGKey(0), ctr_rng.prng_key(0)
    keys = jax.random.split(jkey, n)
    assert (np.asarray(keys) == ctr_rng.split(tkey, n).numpy()).all()

    # the band cells of a MUL: its two pulses' uniforms (split(key)) that
    # lie between both packages' survival probabilities
    tau = [float(jconv.operand_to_tau(v, jcfg.conv)) for v in (x, y)]
    probs = [_pulse_probs(np.array([t], np.float32)) for t in tau]

    def bands(key):
        u = [jax.random.uniform(k, (1024,)) for k in jax.random.split(key)]
        return sum(_ulp_band(np.asarray(u[i]), *probs[i]).sum(-1)
                   for i in range(2))

    band0 = int(bands(jkey))
    jp, jprod = jeng.sc_multiply(jkey, x, y, jcfg)
    tp, tprod = qs.one_mul(tkey, tcfg, "cpu")
    assert abs(float(tp) - float(jp)) * 1024 <= band0
    if band0 == 0:
        assert float(tp) == float(jp) and int(tprod) == int(jprod)

    n_band = np.array([bands(k) for k in keys], np.int64)
    want = np.asarray(jax.vmap(
        lambda k: jeng.sc_multiply(k, x, y, jcfg)[0])(keys))
    got = qs.repeated_muls(tkey, tcfg, "cpu").numpy()
    clean = n_band == 0
    assert (got[clean] == want[clean]).all()
    assert (np.abs(got - want) * 1024 <= n_band).all()
    slack = 1e-6 + n_band.max() / 1024
    assert abs(got.mean() - float(want.mean())) <= slack
    assert abs(got.std() - float(want.std())) <= slack
    print(f"{int((~clean).sum())} of {n} MULs hold an ulp-band cell")
