"""The port's matmul-layout probe (tools/probe_mm.py) against the JAX
package's tools/probe_mosaic_mm.py on the CPU.

The JAX tool is loaded by path and run as it is (`--cpu`: its Pallas
kernel `kern` in interpret mode); `pallas_call` is wrapped so that each
variant's (cells, N) output block comes back to the test through a debug
callback. Tolerance: a scale-relative 1e-4 (max |diff| / max |JAX|), for
float32 sums over 6k-54k rows taken in another order."""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from face_detection_multi_scale_tpu_torch.tools import probe_mm as PM

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """{variant: (2, N) output of the JAX tool's kernel} from one run of
    its main() with --cpu --cells 2 --iters 1, its JSON file in a
    temporary directory."""
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic_mm", ROOT / "tools" / "probe_mosaic_mm.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.OUT = tmp_path_factory.mktemp("probe") / "MOSAIC_MM.json"
    traces = []
    real = pallas.pallas_call

    def capturing(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            got = []  # this trace's outputs, one a run
            traces.append(got)
            jax.debug.callback(lambda v: got.append(np.asarray(v)), out)
            return out
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(pallas, "pallas_call", capturing)
    mp.setattr("sys.argv", ["probe_mosaic_mm.py", "--cpu", "--cells", "2",
                            "--iters", "1"])
    try:
        tool.main()
    finally:
        mp.undo()
    rows = [json.loads(line) for line in tool.OUT.read_text().splitlines()]
    assert [r.get("variant") for r in rows[1:]] == list(PM.VARIANTS)
    assert all("error" not in r for r in rows)
    assert len(traces) == len(PM.VARIANTS)
    return {v: t[0] for v, t in zip(PM.VARIANTS, traces)}


@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_plain_matches_the_jax_kernel(jax_outputs, variant):
    want = jax_outputs[variant]
    assert want.shape == (2, PM.N) and want.dtype == np.float32
    got = PM.probe_mm_plain(variant, *PM.make_inputs("cpu"), cells=2).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= PM.REL_TOL, rel


def test_inputs_match_the_jax_tool():
    """The same seeded bf16 inputs as the JAX tool draws."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    want = [np.asarray(jnp.asarray(rng.randn(*shape) * 0.1, jnp.bfloat16))
            .astype(np.float32) for shape in
            ((PM.R, PM.C, PM.K), (PM.K, PM.N), (9 * PM.K, PM.N))]
    x, x2, w, w9 = PM.make_inputs("cpu")
    for got, ref in zip((x, w, w9), want):
        np.testing.assert_array_equal(got.float().numpy(), ref)
    assert torch.equal(x2, x.reshape(PM.R * PM.C, PM.K))


def test_pre2d_equals_flat_and_the_wrapper_runs_plain_on_cpu():
    inputs = PM.make_inputs("cpu")
    pre2d = PM.probe_mm_plain("pre2d", *inputs, cells=3)
    assert torch.equal(pre2d, PM.probe_mm_plain("flat", *inputs, cells=3))
    assert (pre2d == pre2d[0]).all()
    launches = PM.probe_mm.launches
    for variant in PM.VARIANTS:
        assert torch.equal(PM.probe_mm(variant, *inputs, cells=3),
                           PM.probe_mm_plain(variant, *inputs, cells=3))
    assert PM.probe_mm.launches == launches  # no kernel on the CPU
    assert PM.probe_mm("taps", *inputs, cells=0).shape == (0, PM.N)


def test_cost_counts_the_real_window():
    assert PM.cost("pre2d", 1)[0] == 103_809_024
    assert PM.cost("flat", 1)[0] == 103_809_024
    assert PM.cost("taps", 1)[0] == PM.cost("cat9", 1)[0] == 872_349_696
    assert PM.cost("taps", 512)[0] == 512 * 872_349_696


def test_wrapper_rejects_bad_inputs():
    x, x2, w, w9 = PM.make_inputs("cpu")
    with pytest.raises(ValueError):
        PM.probe_mm("nope", x, x2, w, w9, 1)
    with pytest.raises(TypeError):
        PM.probe_mm("pre2d", x.float(), x2, w, w9, 1)
    with pytest.raises(ValueError):
        PM.probe_mm("pre2d", x, x2, w9, w, 1)
    with pytest.raises(ValueError):
        PM.probe_mm("pre2d", x, x2, w, w9, -1)


def test_cpu_tool_prints_one_line_per_variant(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(PM, "OUT", tmp_path / "PROBE_MM.json")
    PM.main(["--cpu", "--cells", "2", "--iters", "1"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["section"] == "run"
    rows = lines[1:]
    assert [r["variant"] for r in rows] == list(PM.VARIANTS)
    for r in rows:
        assert r["device"] == "cpu" and r["cells"] == 2
        assert r["rel_diff"] == 0.0  # the plain version against itself
        assert {"us_per_cell", "total_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by"} <= set(r)
    saved = [json.loads(s) for s in
             (tmp_path / "PROBE_MM.json").read_text().splitlines()]
    assert saved == lines
