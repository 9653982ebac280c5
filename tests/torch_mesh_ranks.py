"""What each rank of tests/test_torch_mesh.py's process group runs. A module
of its own, without JAX: the ranks are spawned processes that import it
by name (parallel/mesh.run_ranks), and each would otherwise import the
test file's JAX."""

import warnings

import numpy as np
import torch

import torch_shared
from face_detection_multi_scale_tpu_torch.cli import train as TCLI
from face_detection_multi_scale_tpu_torch.infer.detector import FaceDetector
from face_detection_multi_scale_tpu_torch.models import model as TM
from face_detection_multi_scale_tpu_torch.models.convert import (
    jax_to_state_dict)
from face_detection_multi_scale_tpu_torch.models.layers import (
    set_batchnorm_mesh)
from face_detection_multi_scale_tpu_torch.parallel import mesh as PM
from face_detection_multi_scale_tpu_torch.train import checkpoint as CKPT
from face_detection_multi_scale_tpu_torch.train import trainer as TR


def host(net) -> dict:
    """The model's state dict as numpy arrays."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in net.state_dict().items()}


def port_net(spec, variables):
    net = TM.YoloFace(spec)
    net.load_state_dict(jax_to_state_dict(variables))
    return net


def train_steps(spec, variables, cfg, hyp, size, batches, mesh):
    """make_train_step over `batches` (global (images, targets) pairs;
    under a mesh each rank steps on its rows): per step the loss and
    components, the state after the first step and after the last."""
    net = port_net(spec, variables)
    state = TR.create_train_state(net)
    step = TR.make_train_step(net, TR.TrainConfig(**cfg), hyp, size,
                              mesh=mesh)
    losses, first = [], None
    for images, targets in batches:
        if mesh is not None:
            images, targets = PM.shard_batch(mesh, (images, targets))
        state, loss, comps = step(state, images, targets)
        losses.append((float(loss), comps.numpy().copy()))
        first = first or host(net)
    return losses, first, host(net)


def accumulated(spec, variables, cfg, hyp, size, batches, mesh):
    """make_accum_steps: one grad_fn a batch, then one apply_fn at the
    global micro-iteration len(batches) - 1; (losses, the final state)."""
    net = port_net(spec, variables)
    state = TR.create_train_state(net)
    grad_fn, apply_fn = TR.make_accum_steps(net, TR.TrainConfig(**cfg), hyp,
                                            size, mesh=mesh)
    acc, losses = TR.zero_grads_like(state.params), []
    for images, targets in batches:
        if mesh is not None:
            images, targets = PM.shard_batch(mesh, (images, targets))
        state, acc, loss, _ = grad_fn(state, images, targets, acc)
        losses.append(float(loss))
    apply_fn(state, acc, len(batches) - 1)
    return losses, host(net)


def per_shard_bn(spec, variables, cfg, hyp, size, batch, mesh):
    """The control: the mesh step with BatchNorm on this rank's rows only
    (its mesh taken back off); the state after one step."""
    net = port_net(spec, variables)
    state = TR.create_train_state(net)
    step = TR.make_train_step(net, TR.TrainConfig(**cfg), hyp, size,
                              mesh=mesh)
    set_batchnorm_mesh(net, None)
    step(state, *PM.shard_batch(mesh, batch))
    return host(net)


def serve(variables, frames):
    """The mesh detector on the global frames, twice (micro_batch set: the
    inert-under-a-mesh warning once); the Detections as numpy, and the
    number of such warnings."""
    mesh = PM.make_data_mesh()
    det = FaceDetector("yolov7-lite-t", variables=variables,
                       img_sizes=(64,), conf_thres=0.05, max_det=50,
                       mesh=mesh, micro_batch=4, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dets = det.run_network(frames)
        again = det.run_network(frames)
    assert all(torch.equal(a, b) for a, b in zip(dets, again))
    inert = sum("inert under a mesh" in str(w.message) for w in caught)
    return [t.numpy() for t in dets], inert, det.truncation_report()


GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
                 torch.float64, torch.int32, torch.int64, torch.bool,
                 torch.uint8)
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_case(rank: int, dtype) -> torch.Tensor:
    """Rank `rank`'s 2 rows of `dtype` for the gather check: seeded
    values, and in the float types a signed zero, NaNs of both signs and
    an infinity."""
    t = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(rank))
    t = t * 100
    if dtype.is_floating_point:
        t[0, 0] = torch.tensor([-0.0, float("nan"), -float("nan"),
                                float("inf")])
        return t.to(dtype)
    return t > 0 if dtype == torch.bool else t.to(torch.int64).to(dtype)


def bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits as integers (numpy has no bf16)."""
    return t.view(_BITS[t.element_size()]).numpy()


def callers(variables, images, mesh=None):
    """Every entry point that calls run_network, on a lite-t detector
    (API preprocessing at 64 and 128 px, the 128 scale tiled 2 x 2 with a
    32 px halo) with `mesh`: detect_single_scale, detect_multi_scale and
    detect_multi_scale_batch (each 128 scale one tile batch),
    detect_batch and predict; their arrays, in order."""
    det = FaceDetector("yolov7-lite-t", variables=variables,
                       img_sizes=(64, 128), conf_thres=0.05, max_det=50,
                       use_api_preprocess=True, tile_top_scale=2,
                       tile_halo=32, tile_min_size=128, mesh=mesh,
                       device="cpu")
    out = [det.detect_single_scale(images[0], 64)[0],
           det.detect_multi_scale(images[1])[0]]
    out += det.detect_multi_scale_batch(images)
    out += det.detect_batch(images, 64)
    out += det.predict([im[:64, :64, ::-1] for im in images], size=64).pred
    return out, det.truncation_report()


def memory_sets(seed: int, n_train: int, n_val: int, size: int,
                stride: int):
    """Seeded in-memory training and validation sets."""
    rng = np.random.default_rng(seed)
    return (torch_shared.memory_faces(rng, n_train, size, stride),
            torch_shared.memory_faces(rng, n_val, size, stride))


def rank_main(payload):
    """Everything one rank of the 4-rank world does: serving, the train
    steps, the accumulation pair, the per-shard-BN control, the checkpoint
    gate, and `train_run` over the first 2 ranks (global batch 2)."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = {"serve": serve(payload["variables"], payload["frames"])}
    mesh = PM.make_data_mesh()
    out["callers"] = callers(payload["variables"], payload["images"], mesh)
    out["gather"] = {str(dt): bits(PM.gather_rows(
        mesh, gather_case(rank, dt), 2 * mesh.size)) for dt in GATHER_DTYPES}
    train = (payload["spec"], payload["train_variables"], payload["cfg"],
             payload["hyp"], payload["size"])
    out["steps"] = train_steps(*train, payload["batches"], mesh)
    out["accum"] = accumulated(*train, payload["accum_batches"], mesh)
    out["per_shard_bn"] = per_shard_bn(*train, payload["batches"][0], mesh)

    net = port_net(payload["spec"], payload["train_variables"])
    gate_dir = payload["tmp"] / f"gate{rank}"
    gate_dir.mkdir()
    CKPT.save_checkpoint(str(gate_dir), "last", TR.create_train_state(net),
                         {"epoch": 0})
    writer = CKPT.AsyncCheckpointWriter()
    writer.save(str(gate_dir), "best", TR.create_train_state(net),
                {"epoch": 0})
    writer.close()
    out["gate_files"] = sorted(p.name for p in gate_dir.iterdir())

    args = TCLI.parse_args(payload["cli"])
    TCLI.train_run(args, datasets=memory_sets(*payload["sets"]), quiet=True)
    last = getattr(TCLI.train_run, "last", None)
    out["train_run"] = None if last is None else (
        last["save_dir"], host(last["state"].model))
    return out
