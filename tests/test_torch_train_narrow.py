"""The port's train step on yolov7-tiny-face narrowed to width 0.25
(tests/test_torch_model.py's narrowing) against the JAX package's, with
the checks, weights, batches and tolerances of
tests/test_torch_train_step.py (which runs them on yolov7-lite-t); and
the BatchNorm update of models/layers.BatchNorm against flax's. The JAX
side runs in float64 here (test_torch_train_step.Case says why)."""

import numpy as np
import pytest
import torch

from face_detection_multi_scale_tpu.train import trainer as JR
from face_detection_multi_scale_tpu_torch.models import layers as TLY
from face_detection_multi_scale_tpu_torch.train import trainer as TR

from test_torch_train_step import (
    assert_bn, case, check_accumulated, check_freeze, check_one_step,
    torch_tree)

BN_RTOL = 1e-4
KEY = "tiny"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU steps on one thread for this module: beside the
    other test workers, torch's thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("optimizer,step", [("sgd", 2), ("adam", 5)])
def test_one_step_matches_jax(optimizer, step):
    check_one_step(KEY, optimizer, step)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_accumulated_steps_match_jax(optimizer):
    check_accumulated(KEY, optimizer)


def test_freeze_summary_matches_jax():
    """freeze_summary's (frozen, trainable, layers) equal the JAX ones."""
    c = case(KEY)
    net = c.port()
    for freeze_until in (None, 0, 5, 40, 200):
        assert TR.freeze_summary(net, freeze_until) == JR.freeze_summary(
            c.variables["params"], freeze_until), freeze_until


@pytest.mark.parametrize("freeze_until", [0, 20])
def test_freeze_step_matches_jax(freeze_until):
    check_freeze(KEY, freeze_until)


def test_batch_norm_running_statistics_match_flax(monkeypatch):
    """One train-mode forward of narrowed tiny: every running_mean /
    running_var within rtol 1e-4 (means also atol 1e-5) of the JAX
    statistics, those of `model.apply(variables, images, train=True,
    mutable=["batch_stats"])` inside the JAX train step, whose BN folds
    in the biased batch variance. torch's own nn.BatchNorm2d update (the
    unbiased variance, n/(n-1) larger) misses them on the small maps."""
    c = case(KEY)
    images = c.batches[0][0].astype(np.float32) / 255.0
    stats = c.jax_grads(0)[3]
    want = torch_tree(c.variables["params"], stats)

    def stats_after_forward():
        net = c.port().train()
        with torch.no_grad():
            net(torch.from_numpy(images))
        return {k: v for k, v in net.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    got = stats_after_forward()
    assert len(got) == sum(k.endswith(("running_mean", "running_var"))
                           for k in want)
    for key, v in got.items():
        assert_bn(key, v, want[key])
    monkeypatch.setattr(TLY.BatchNorm, "forward",
                        torch.nn.BatchNorm2d.forward)
    plain = stats_after_forward()
    worst = max(float(((plain[k] - want[k]).abs()
                       / want[k].abs()).max()) for k in plain
                if k.endswith("running_var"))
    assert worst > 10 * BN_RTOL
