"""Faults planted under a run's timed path, to show that ``correct`` comes out false for
each fault a cell can have: the tests run them on the CPU at tiny sizes, and
``bench_port.control --fault <name>`` reads them on a card at a cell's own size.

Each extraction fault wraps the step and the scorer a cell's set-up made; each training
fault wraps the port's step makers, so the first calls already run broken."""

from __future__ import annotations

import contextlib

import torch


def stale(step, score):
    """Every batch answered with the previous batch's features."""
    last = []

    def run(x):
        out = step(x)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return run, score


def half_batch(step, score):
    """Half of the batch computed; the other half given the mean of the computed half."""
    def run(x):
        h = x.shape[0] // 2
        out = step(x[:h])
        return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - h, -1)])
    return run, score


def altered_answer(step, score):
    """Each clip's features altered where they are produced."""
    return (lambda x: step(x) * 1.2), score


def altered_score(step, score):
    """Each video's clip scores altered where they are produced."""
    return step, (lambda video, mask: score(video, mask) + 0.01)


EXTRACT = {"stale": stale, "half_batch": half_batch, "altered_answer": altered_answer,
           "altered_score": altered_score}


def unchanged_state(make):
    """A step that leaves the models' parameters and statistics as they were."""
    def maker(*args, **kw):
        step = make(*args, **kw)
        models = [a for a in args if isinstance(a, torch.nn.Module)]

        def run(*a, **k):
            saved = [{n: t.detach().clone() for n, t in m.state_dict().items()} for m in models]
            out = step(*a, **k)
            for m, s in zip(models, saved):
                m.load_state_dict(s)
            return out
        return run
    return maker


def half_train_batch(make):
    """Half of each modality's batch left out; the step is the rest's."""
    def maker(*args, **kw):
        step = make(*args, **kw)

        def run(v1, v2, clips, labels, *a, **k):
            hv, hc = max(2, v1.shape[0] // 2), max(2, clips.shape[0] // 2)
            return step(v1[:hv], v2[:hv], clips[:hc], labels[:hc], *a, **k)
        return run
    return maker


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_train_batch}


@contextlib.contextmanager
def planted(kind: str, name: str):
    """The fault ``name`` planted for cells of ``kind`` ("extract" or "adv_train")
    while the block runs."""
    if kind == "extract":
        from bench_port.kinds import extract

        fault, setup = EXTRACT[name], extract.ExtractCell.setup

        def broken_setup(self, build=True):
            setup(self, build)
            self.extract, self.score_fn = fault(self.extract, self.score_fn)

        extract.ExtractCell.setup = broken_setup
        try:
            yield
        finally:
            extract.ExtractCell.setup = setup
        return
    import ted_spad_tpu_torch.stages.anonymization_training as at

    fault, saved = TRAIN[name], (at.make_fa_step, at.make_fbft_step)
    at.make_fa_step, at.make_fbft_step = fault(saved[0]), fault(saved[1])
    try:
        yield
    finally:
        at.make_fa_step, at.make_fbft_step = saved
