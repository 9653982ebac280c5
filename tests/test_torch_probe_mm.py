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


def emulate_plan(variant, x, x2, w, w9):
    """The kernel's tiling (csrc/probe_mm.cu) in torch, float32, one cell:
    x rows staged into slots of PM.plan's size (flattened rows 176 r ..,
    zeros past x), output row o's tap (dy, dx) read as the slot of x row
    o + dy from row dx on (a row offset of 176 dy + dx in x2), columns 174
    and 175 masked, each tile's product summed tile by tile: per tap for
    taps, after the K = 1152 product for cat9."""
    p = PM.plan(variant)
    tapped = variant in ("taps", "cat9")
    src = (x if variant == "flat" else x2).float().reshape(PM.R * PM.C, PM.K)

    def slot(r):
        s = torch.zeros(p["slot_rows"], PM.K)
        n = min(p["rows"], (PM.R - r) * PM.C)
        s[:n] = src[r * PM.C:r * PM.C + n]
        return s

    taps = PM.TAPS if tapped else [(0, 0)]
    keep = torch.ones(PM.C, 1)
    if tapped:
        keep[PM.CQ:] = 0  # positions outside the 34 x 174 window
    tot = torch.zeros(PM.N)
    for o in range(PM.RQ if tapped else PM.R):
        acc = torch.zeros(PM.C, PM.N)
        for t, (dy, dx) in enumerate(taps):
            b = slot(o + dy)[dx:dx + PM.C]
            assert b.shape[0] == PM.C  # the window stays inside its slot
            wt = w9[t * PM.K:(t + 1) * PM.K] if variant == "cat9" else w
            d = b @ wt.float()
            if variant == "cat9":
                acc += d
            else:
                tot += (d * keep).sum(0)
        if variant == "cat9":
            tot += (acc * keep).sum(0)
    return tot


@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_kernel_plan_emulation_matches_plain(variant):
    inputs = PM.make_inputs("cpu")
    want = PM.probe_mm_plain(variant, *inputs, cells=1)[0]
    got = emulate_plan(variant, *inputs)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= PM.REL_TOL, rel


@pytest.mark.parametrize("variant", PM.VARIANTS)
def test_kernel_plan_covers_every_window_row_once(variant):
    """Per tap, the unmasked (output row, column) positions of the plan
    read each row of the tap's window exactly once, and no masked position
    is inside the window."""
    p = PM.plan(variant)
    tapped = variant in ("taps", "cat9")
    tiles = PM.RQ if tapped else PM.R
    for dy, dx in (PM.TAPS if tapped else [(0, 0)]):
        seen = np.zeros(PM.R * PM.C, int)
        for o in range(tiles):
            assert o + dy < PM.R and dx + PM.C <= p["slot_rows"]
            for c in range(PM.CQ if tapped else PM.C):
                seen[(o + dy) * PM.C + c + dx] += 1
        window = np.zeros((PM.R, PM.C), int)
        if tapped:
            window[dy:dy + PM.RQ, dx:dx + PM.CQ] = 1
        else:
            window[:] = 1
        np.testing.assert_array_equal(seen, window.ravel())


def test_staged_bytes_match_a_hand_count():
    row, slab = 176 * 128 * 2, 128 * 64 * 2
    assert PM.X_BYTES == 1_622_016 == 36 * row
    halo = (35 * 178 + 176) * 256  # the last row's halo lies past x
    want = {"pre2d": 36 * row + slab, "flat": 36 * row + slab,
            "taps": halo + slab, "cat9": halo + 17 * 9 * slab}
    assert want == {"pre2d": 1_638_400, "flat": 1_638_400,
                    "taps": 1_656_320, "cat9": 4_146_688}
    for variant, n in want.items():
        p = PM.plan(variant)
        assert PM.staged_bytes(variant) == n == p["x_bytes"] + p["w_bytes"]
        # x crosses into shared memory about once a cell, not nine times
        assert p["x_bytes"] <= 2 * PM.X_BYTES
    assert PM.plan("taps")["w_bytes"] == slab


def test_count_staged_needs_the_card():
    """The staged-byte count is taken by the kernel: on CPU tensors, where
    the wrapper runs the plain version, there is nothing to count."""
    with pytest.raises(ValueError, match="CUDA"):
        PM.count_staged("taps", *PM.make_inputs("cpu"), 1)


def test_ab_tool_writes_the_replaced_source(tmp_path, monkeypatch):
    from face_detection_multi_scale_tpu_torch.ops import cuda_build
    from face_detection_multi_scale_tpu_torch.tools import probe_mm_ab as AB

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    assert AB.source_for("base", 0) == PM.SOURCE
    path = AB.source_for("cp.async.ca.=>cp.async.cg.", 1)
    assert path.parent == tmp_path
    text = path.read_text()
    assert "cp.async.cg." in text and "cp.async.ca." not in text
    assert text.replace("cp.async.cg.", "cp.async.ca.") == \
        PM.SOURCE.read_text()
    with pytest.raises(SystemExit, match="no"):
        AB.source_for("no such text=>x", 2)
