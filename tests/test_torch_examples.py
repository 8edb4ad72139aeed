"""The port's examples against the JAX package's.

``blocksparse_tpu_torch.examples.simple`` prints the lines of
``examples/simple.py`` under one ``np.random.seed`` (the same layout, x
and identity weights, y bit for bit).  ``blocksparse_tpu_torch.examples.
mnist`` from the JAX example's ``init_params`` takes JAX's steps: three
steps at batch 32, each loss and every parameter after them within 1e-5
of JAX's, relative to the tensor's largest magnitude (the same f32
model, its sums in other orders; Adam's first steps move each weight by
about the learning rate, 1e-3, whatever the gradient's size, so a
gradient both sides compute within rounding gives the same step).  With
``--quantize`` a step runs and the tracker's exponents move off the
specs' defaults.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch
import jax

from blocksparse_tpu.ops import quantize as jax_quantize
from blocksparse_tpu_torch.examples import mnist, simple

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_simple_prints_the_jax_example_lines(capsys):
    np.random.seed(0)
    load_jax_example("simple")
    want = capsys.readouterr().out
    np.random.seed(0)
    assert simple.main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("y shape: (4096, 64) blocks: ")


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))


def test_mnist_steps_match_jax(monkeypatch, capsys):
    jax_mnist = load_jax_example("mnist")
    steps = []

    class Recorder(jax_quantize.QuantizeTracker):
        """The JAX example's tracker, recording each step's output."""

        def wrap_jit(self, fn, **kw):
            inner = super().wrap_jit(fn, **kw)

            def step(*args):
                out = inner(*args)
                steps.append((jax.tree_util.tree_leaves(out[0]),
                              float(out[2])))
                return out
            return step

    monkeypatch.setattr(jax_mnist, "QuantizeTracker", Recorder)
    monkeypatch.setattr(sys, "argv", ["mnist.py", "--n_iter", "3",
                                      "--batch", "32"])
    jax_mnist.main()
    want_out = capsys.readouterr().out
    params = mnist.params_from_jax(
        jax.tree_util.tree_map(np.asarray,
                               jax_mnist.init_params(jax.random.PRNGKey(0))))
    out = mnist.train(mnist.parse_args(["--n_iter", "3", "--batch", "32",
                                        "--device", "cpu"]),
                      params, torch.device("cpu"))
    got_out = capsys.readouterr().out
    assert len(steps) == 3
    for loss, (_, want) in zip(out["losses"], steps):
        assert abs(float(loss) - want) <= TOL * abs(want)
    final = list(out["params"].values())
    assert len(final) == len(steps[-1][0])
    for got, want in zip(final, steps[-1][0]):
        _close(got, want)
    # the same lines but for the clock
    def strip(text):
        return [line.split(" (")[0] for line in text.splitlines()]
    assert strip(got_out)[-1] == strip(want_out)[-1]
    assert len(strip(got_out)) == len(strip(want_out)) == 3


def test_mnist_quantized_step_tracks_emax(capsys):
    out = mnist.train(mnist.parse_args(["--n_iter", "1", "--batch", "32",
                                        "--quantize", "--device", "cpu"]),
                      mnist.init_params(torch.Generator().manual_seed(0)),
                      torch.device("cpu"))
    fwd, bwd = mnist.make_qspecs(True)
    emax = {k: float(v) for k, v in out["tracker"].emax.items()}
    names = [f"{t}{l}" for l in range(2) for t in "qk"]
    assert sorted(emax) == sorted(names + [n + "_grad" for n in names])
    for name in names:
        assert emax[name] != fwd.emax and emax[name + "_grad"] != bwd.emax
    assert np.isfinite(float(out["losses"][0]))
    assert "train accuracy: " in capsys.readouterr().out


def test_mnist_entry_point_runs_on_the_cpu(capsys):
    assert mnist.main(["--device", "cpu", "--n_iter", "2", "--batch",
                       "64"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("iter    0 loss ")
    assert lines[-1].startswith("train accuracy: ")
