"""Faults planted under the timed path, to show that `correct` catches them.

Each is a context manager that patches the program while it is open:

* ``unchanged``: the pose graph's optimize returns the state unchanged;
* ``half``: half of the batch left out (half of each group's frames, or
  every second sequence of a lockstep frame, never stepped);
* ``altered``: an answer altered where it is produced (each registration's
  transform moved 2 cm after its score).

The cells run on one chip, so there is no exchange between chips to leave
out. Used by ``control.py --fault`` on the card and by the CPU tests.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half", "altered")


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def optimize_does_nothing():
    from rgbdslam_v2_tpu_torch.graph import manager
    from rgbdslam_v2_tpu_torch.parallel import slam_multi

    def unchanged(g, *a, **kw):
        return torch.zeros((), device=g.poses.device), 0

    with patched(manager, "optimize", unchanged), patched(slam_multi, "optimize", unchanged):
        yield


@contextlib.contextmanager
def half_the_batch(driver: str):
    if driver == "serial":
        from rgbdslam_v2_tpu_torch.pipeline.slam import SlamPipeline

        group = SlamPipeline._process_group

        def halved(self, compacts, stamps):
            half = max(1, len(compacts) // 2)
            group(self, compacts[:half], stamps[:half])
            self.n_processed += len(compacts) - half

        with patched(SlamPipeline, "_process_group", halved):
            yield
    else:
        from rgbdslam_v2_tpu_torch.parallel import slam_multi

        step = slam_multi.slam_stepN
        seen = []

        def every_other(store, graph, views, gen, wire, **cfg):
            """Every second sequence's step is never run: its summary reads
            nothing accepted and its node is not written."""
            if len(seen) % 2:
                seen.append(None)
                return torch.zeros_like(seen[0])
            out = step(store, graph, views, gen, wire, **cfg)
            seen.append(out)
            return out

        with patched(slam_multi, "slam_stepN", every_other):
            yield


@contextlib.contextmanager
def answers_altered():
    from rgbdslam_v2_tpu_torch.graph import compare

    register = compare.ransac_register

    def moved(*a, **kw):
        res = register(*a, **kw)
        T = res.transform.clone()
        T[:, :3, 3] += 0.02
        return res._replace(transform=T)

    with patched(compare, "ransac_register", moved):
        yield


def planted(name: str, driver: str):
    """The context manager of fault `name` for a cell of `driver`."""
    return {"unchanged": optimize_does_nothing, "half": lambda: half_the_batch(driver),
            "altered": answers_altered}[name]()
