"""The traced run: the benchmark's own spans around calls into the
program's layers (`layers.json`), a torch.profiler trace of the window,
and the reduction of both to what the per-layer metric readers take.

Spans are installed only in a traced run. Each entry of `layers.json`
names a span and its target, `module:attribute` (a class method as
`Class.method`); a target that is missing fails the run. An entry with
`record` also keeps what the yardstick needs of every call: "group" the
fused group's shapes (its bound, `counts.group_bound_s`), "keep" the
keep mask and its valid flags (`counts.keep_bound_s`, after the window).
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import counts

LAYERS = Path(__file__).resolve().parent / "layers.json"
PREFIX = "portbench."


class Spans:
    """The wrappers of one traced run; `remove()` puts the program back."""

    def __init__(self):
        self.undo = []
        self.group_bounds: List[float] = []
        self.keeps: List = []
        with open(LAYERS) as f:
            self.entries = json.load(f)

    def install(self) -> "Spans":
        for e in self.entries:
            mod_name, attr = e["target"].split(":")
            owner = importlib.import_module(mod_name)
            *path, name = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            if name not in vars(owner):
                raise SystemExit(f"layers.json: {e['target']} is missing")
            fn = vars(owner)[name]
            setattr(owner, name, self._wrap(fn, e["span"], e.get("record")))
            self.undo.append((owner, name, fn))
        return self

    def _wrap(self, fn, span: str, record: Optional[str]):
        label = PREFIX + span

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
            if record == "group":
                x, weights = args[0], args[1]
                self.group_bounds.append(counts.group_bound_s(
                    x.shape, x.element_size(),
                    [(w.shape, w.element_size()) for w in weights],
                    out.shape)[0])
            elif record == "keep":
                self.keeps.append((out, args[1]))
            return out

        return wrapped

    def remove(self) -> None:
        for owner, name, fn in reversed(self.undo):
            setattr(owner, name, fn)
        self.undo = []

    def keep_bounds(self) -> List[float]:
        return [counts.keep_bound_s(k, v) for k, v in self.keeps]


def profiler():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(spans):
    """Merged, sorted (start, end) intervals."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Reading:
    """What the trace says about the window, in seconds."""

    def __init__(self, prof, spans: Spans, window_s: float):
        evs = prof.profiler.kineto_results.events()
        dev, launch, front, user, top = [], {}, {}, {}, []
        for e in evs:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.name().startswith(PREFIX):  # not a span's copy
                    dev.append((start, end, e.name(), e.correlation_id(),
                                e.linked_correlation_id()))
                continue
            if e.name().startswith("cu"):  # a runtime or driver call:
                launch[e.correlation_id()] = start  # its device work's id
            elif e.linked_correlation_id() == 0:  # a frontend op or span
                front[e.correlation_id()] = start
            if e.name().startswith(PREFIX):
                user.setdefault(e.name()[len(PREFIX):], []).append(
                    (start, end))
            elif not e.name().startswith("cu"):
                top.append((start, end, e.name()))
        self.window_s = window_s
        self.busy = _union([(a, b) for a, b, *_ in dev])
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self.kernels: Dict[str, float] = {}
        for a, b, name, *_ in dev:
            self.kernels[name] = self.kernels.get(name, 0.0) + (b - a) / 1e9
        self.spans = {k: _union(v) for k, v in user.items()}
        self.span_calls = user
        self.dev = dev
        self.launch, self.front = launch, front
        self.top = top
        self.group_bounds = spans.group_bounds
        self.keep_bounds = spans.keep_bounds()

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose name holds one of
        `names`."""
        return sum(v for k, v in self.kernels.items()
                   if any(n in k for n in names))

    def span_wall_s(self, span: str) -> float:
        return sum(b - a for a, b in self.span_calls.get(span, [])) / 1e9

    def span_device_s(self, span: str) -> Optional[float]:
        """Device seconds of the work launched inside `span`: each device
        operation timed by the runtime call that launched it (its
        correlation id), else by the frontend op it links to; None when
        no device operation could be tied."""
        ivs = self.spans.get(span, [])
        starts = [a for a, _ in ivs]
        total, tied = 0.0, 0
        for a, b, _, corr, linked in self.dev:
            t = self.launch.get(corr, self.front.get(linked))
            if t is None:
                continue
            tied += 1
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= ivs[j][1]:
                total += (b - a) / 1e9
        return total if tied else None

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((b2[0] - b1[1], b1[1], b2[0]) for b1, b2
                       in zip(self.busy, self.busy[1:])), reverse=True)[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[self.doing((a + b) // 2), g / 1e9]
                              for g, a, b in gaps]}

    def doing(self, t: int) -> str:
        """The innermost span the host was in at `t`, else its innermost
        operation, else "host"."""
        best = None
        for name, ivs in self.span_calls.items():
            for a, b in ivs:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, "span " + name)
        if best is None:
            for a, b, name in self.top:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, name)
        return best[1][:120] if best else "host"
