"""The one general traffic generator. A traffic mix (``traffic/<mix>.json``)
names its loop and sets its parameters; the loop builds the configuration's
scene through the program, warms up the shapes it will use, runs the
measured window and keeps what the reference will check.

* ``frames``: interactive frames, a closed loop of one user. Each frame
  renders the next pose of the seeded camera path through the program's
  ``render`` and waits for it on the card; its latency is the host clock
  from the call to the synchronise. A seeded sample of the window's frames
  (reservoir sampling, so late frames are as likely as early ones) is kept
  for the check.
* ``train``: inverse rendering. The program's trainer (``make_train_step``,
  a world of one) takes SGD steps on the material bank toward seeded
  targets, cycling through ``views`` camera poses (evenly spaced on the
  configuration's path, the same set for every seed). Set-up drives it
  through its first ``checked_steps`` steps (their losses and the bank
  before, after one and after all of them are kept for the check) and the
  window continues from that same state. Every step ends in a synchronise,
  as a loop that logs each step's loss would."""

from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

from . import seeded
from .reference import render as ref
from .reference import train as ref_train
from .scene import make_inputs, program_scene, reference_scene


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    """What a window measured: units completed, its length, each unit's
    latency (seconds), the units' indices in the loop's order."""

    units: int
    seconds: float
    latencies: list
    first_index: int
    failed: int


class Loop:
    def __init__(self, port, cfg: dict, mix: dict, seed: int, device):
        self.port, self.cfg, self.mix, self.seed, self.device = port, cfg, mix, seed, device
        self.width, self.height = cfg["width"], cfg["height"]
        self.path = cfg["camera"]
        self.next_index = 0

    def camera(self, pose):
        return self.port.Camera(position=pose[0:3], yaw=pose[3], pitch=pose[4], aspect=self.width / self.height)

    def run(self, seconds: float | None = None, units: int | None = None, span=None) -> Window:
        """Run units back to back until ``seconds`` have passed (the unit in
        flight completes and counts) or ``units`` are done."""
        lat, failed = [], 0
        first = self.next_index
        t_w0 = time.perf_counter()
        t1 = t_w0
        while True:
            k = self.next_index
            t0 = time.perf_counter()
            try:
                if span is None:
                    self.unit(k)
                else:
                    with torch.profiler.record_function(span):
                        self.unit(k)
                sync(self.device)
            except RuntimeError as exc:  # a unit the program refuses (a binning overflow) counts as failed
                print(f"gpu_bench: unit {k} failed: {exc}", file=sys.stderr)
                failed += 1
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            self.next_index += 1
            if (units is not None and len(lat) >= units) or (seconds is not None and t1 - t_w0 >= seconds):
                break
        return Window(units=len(lat), seconds=t1 - t_w0, latencies=lat, first_index=first, failed=failed)


class Frames(Loop):
    def setup(self) -> None:
        inputs = make_inputs(self.cfg, self.seed, self.device)
        self.scene = program_scene(self.port, self.cfg, inputs, self.device)
        self.num_poses = int(self.path["poses"])
        self.poses = torch.as_tensor(seeded.camera_path(self.seed, self.path, self.num_poses), device=self.device)
        self.rng = random.Random(self.seed)
        self.kept: list = []  # (frame index, frame)
        self.sample = int(self.mix["sample_frames"])
        self.keeping, self.seen = False, 0
        for _ in range(int(self.mix["warmup"])):
            self.unit(self.next_index)
            self.next_index += 1
        sync(self.device)
        self.keeping = True

    def unit(self, k: int) -> None:
        img = self.port.render(self.scene, self.camera(self.poses[k % self.num_poses]), width=self.width,
                               height=self.height)
        if self.keeping:  # reservoir sampling over the window's frames
            if len(self.kept) < self.sample:
                self.kept.append((k, img))
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.sample:
                    self.kept[j] = (k, img)
            self.seen += 1

    def release(self) -> None:
        del self.scene

    def check_numbers(self, check) -> dict:
        """Render the kept frames' poses with the reference; compare."""
        inputs = make_inputs(self.cfg, self.seed, self.device)
        rs = reference_scene(self.cfg, inputs, self.device)
        refs, frames = [], []
        for k, img in sorted(self.kept, key=lambda x: x[0]):
            pose = self.poses[k % self.num_poses]
            with torch.no_grad():
                refs.append(ref.render(rs, pose[0:3], pose[3], pose[4], self.width, self.height))
            frames.append(img)
        return check.frame_numbers(frames, refs)

    def pose_of(self, k: int):
        return self.poses[k % self.num_poses]


def train_views(seed: int, path: dict, views: int, device) -> torch.Tensor:
    """(views, 5) poses at the loop's ``views`` evenly spaced points, the same
    for every seed; the seed picks the first and the direction."""
    return torch.as_tensor(seeded.camera_path(seed, dict(path, poses=views), views), device=device)


class Train(Loop):
    def setup(self) -> None:
        inputs = make_inputs(self.cfg, self.seed, self.device)
        self.scene = program_scene(self.port, self.cfg, inputs, self.device)
        self.views = int(self.mix["views"])
        self.poses = train_views(self.seed, self.path, self.views, self.device)
        self.targets = seeded.targets(self.seed, self.views, self.height, self.width, self.device)
        self.lr = float(self.mix["learning_rate"])
        self.step = self.port.make_train_step(width=self.width, height=self.height, learning_rate=self.lr)
        n = int(self.mix["checked_steps"])
        self.p0 = self._bank()
        self.losses = []
        for k in range(n):
            self.unit(k)
            self.losses.append(float(self.loss))
            if k == 0:
                self.p1 = self._bank()
        self.pn = self._bank()
        self.next_index = n
        sync(self.device)

    def _bank(self) -> dict:
        mats = self.scene.materials
        return {k: getattr(mats, k).detach().clone() for k in mats.tensor_fields()
                if getattr(mats, k).is_floating_point()}

    def unit(self, k: int) -> None:
        v = k % self.views
        self.scene, self.loss = self.step(self.scene, self.camera(self.poses[v]), self.targets[v])

    def release(self) -> None:
        del self.scene, self.step, self.loss

    def check_numbers(self, check) -> dict:
        """Run the reference's checked steps from the configuration's bank;
        compare losses, the first gradient and the bank's change."""
        inputs = make_inputs(self.cfg, self.seed, self.device)
        rs = reference_scene(self.cfg, inputs, self.device)
        n = len(self.losses)
        idx = [k % self.views for k in range(n)]
        losses, g1, banks = ref_train.sgd_steps(rs, [self.poses[i] for i in idx], [self.targets[i] for i in idx],
                                                self.width, self.height, self.lr)
        prog = dict(losses=self.losses, p0=self.p0, p1=self.p1, pn=self.pn)
        refd = dict(losses=losses, p0=rs.bank, p1=banks[0], pn=banks[-1], g1=g1)
        return check.train_numbers(prog, refd, self.lr)

    def pose_of(self, k: int):
        return self.poses[k % self.views]


LOOPS = {"frames": Frames, "train": Train}
