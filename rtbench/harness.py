"""The benchmark's run of one cell: the scene from the seed, the program's
set-up and warm frames, the measured window of whole frames, the
per-layer reading of a profiled stretch of it, and the comparison with
the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is data found by name (``BENCHMARK.json``):

- a configuration: its file (``configs/<config>.json``): the scene, the
  build and tracer, the image size, the bounces;
- a scene kind: ``scenes/<kind>.py``, named by the configuration's
  ``scene.kind``; it supplies
  - ``inputs(scene, seed)``: the host inputs both sides are handed, with
    ``aabb`` (the world box the camera moves about), ``material`` and
    ``light`` (what both sides shade with) and ``counts`` (numbers the
    metric readers take, such as ``num_triangles``);
  - ``Program(scene, inputs, argv, device)``: the program's set-up through
    its app's own functions, from ``argv`` (the app's flags for the build,
    tracer, image and animation) and the scene's own flags; it holds
    ``args``, ``dev_scene``, the first structures ``trav`` and ``packed``,
    and ``tracers`` (the keyword arguments of ``path_trace``; ``tracer``
    serves ``render_frame``); ``step(t)`` updates the structures of an
    animated step and returns its build time in ms, ``reseed()`` goes back
    to set-up's state;
  - ``Reference(inputs, device)``: the reference's side, whose
    ``geometry(t, dtype)`` gives a capture's (caster, normals): an object
    with ``reference.Caster``'s ``closest`` and ``occluded``, and the
    normals of its hit ids;
- a camera: ``cameras/<camera>.py``, named by the traffic's ``camera``,
  whose ``pose(aabb_min, aabb_max, step, period)`` gives a step's camera;
- a traffic mix: ``traffic/<traffic>.json``, the parameters of the one
  frame loop below (camera path and its period, animation, render modes,
  warm steps, the profiled stretch, the capture frames);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the metric's value or None;
- a cell's limits for the comparison: ``limits/<workload>.json``.

Each of these files is loaded from the checkout (``root``) that
``resolve`` was given.

The program under test is ``tpu_raytracing_torch``, driven through its
app's own functions (``app/main.py``), which the scene kind calls for the
structures and the loop below calls for each image: ``path_trace`` and
``render_frame`` with the tracers the app makes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from rtbench import judge, tracefold

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
# modules a run may never load (compared by the top-level name, whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_raytracing")
# per traversal call: rays sampled uniformly and toward the front (where a
# compacted batch keeps its live rays)
HIT_SAMPLES = 256
PIXEL_SAMPLES = 512
# a breakdown entry's name is cut to this many characters (kernel names
# carry their whole template signature)
NAME_CHARS = 160


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: Path = REPO) -> dict:
    """The cell named ``workload`` with everything it names: its
    configuration, traffic, limits and the metrics it reports."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[cell["config"]]
    bench = root / "rtbench"

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(
        cell=cell,
        config=load_json(root / entry["file"]),
        traffic=load_json(bench / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=reported(spec["end_to_end"]),
        per_layer=reported(spec["per_layer"]),
        root=root,
    )


def load_module(folder: str, name: str, root: Path = REPO):
    """The module ``rtbench/<folder>/<name>.py`` of the checkout ``root``."""
    path = root / "rtbench" / folder / f"{name}.py"
    tag = f"rtbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: Path = REPO):
    """The reader module of the per-layer metric ``name``."""
    return load_module("metrics", name, root)


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that a run may not load."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed from the run's seed and ``keys``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 128), *keys])
    return int(ss.generate_state(2, dtype=np.uint64)[0]) & ((1 << 63) - 1)


def frame_stats(times_s: List[float], window_s: float) -> Dict[str, float]:
    """``frame_ms`` (window over frames) and ``frame_ms_p95`` (the 95th
    percentile of every frame's time, linear between ranks)."""
    n = len(times_s)
    return dict(frame_ms=window_s / n * 1e3,
                frame_ms_p95=float(np.percentile(np.asarray(times_s) * 1e3, 95)))


# ---------------------------------------------------------------------------
# The tracer wrapper: capture samples, count live rays
# ---------------------------------------------------------------------------


class Recorder:
    """Wraps one of the program's tracers. While ``capture`` is a list it
    keeps a sample of each call's rays and hits; while ``live`` is a list
    it keeps each call's live-ray count (a device scalar)."""

    def __init__(self, tracer, any_hit: bool, sampler):
        self.tracer = tracer
        self.any_hit = any_hit
        self.sampler = sampler
        self.capture: Optional[list] = None
        self.live: Optional[list] = None

    def __call__(self, trav, pairs, rays, active=None):
        rec, stats = self.tracer(trav, pairs, rays, active=active)
        num = rays.origin.shape[0]
        if self.capture is not None:
            idx = self.sampler(num, rays.origin.device)
            act = (torch.ones_like(idx, dtype=torch.bool) if active is None else active[idx])
            self.capture.append(dict(
                any_hit=self.any_hit, o=rays.origin[idx], d=rays.direction[idx],
                tmin=rays.tmin[idx], tmax=rays.tmax[idx], active=act, hit=rec.hit[idx],
                t=rec.t[idx]))
        if self.live is not None:
            self.live.append(num if active is None else active.sum())
        return rec, stats


class Sampler:
    """Seeded ray indices per batch size: half uniform, half drawn toward
    the front of the batch."""

    def __init__(self, seed: int, count: int):
        self.seed = seed
        self.count = count
        self.cache: Dict[tuple, torch.Tensor] = {}

    def __call__(self, num: int, device) -> torch.Tensor:
        key = (num, str(device))
        if key not in self.cache:
            rng = np.random.default_rng(sub_seed(self.seed, 7, num))
            half = self.count // 2
            idx = np.concatenate([rng.integers(0, num, half),
                                  (num * rng.random(self.count - half) ** 4).astype(np.int64)])
            self.cache[key] = torch.as_tensor(np.unique(np.minimum(idx, num - 1)), device=device)
        return self.cache[key]


# ---------------------------------------------------------------------------
# The cell: set-up and one camera step of the frame loop
# ---------------------------------------------------------------------------


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


class Cell:
    """One configuration under one traffic mix, set up on ``device``."""

    def __init__(self, resolved: dict, seed: int, device, trace: bool, overrides=None):
        overrides = overrides or {}
        root = resolved["root"]
        cfg = _merge(resolved["config"], overrides.get("config"))
        self.traffic = tr = _merge(resolved["traffic"], overrides.get("traffic"))
        self.seed = seed
        self.device = torch.device(device)
        self.trace = trace
        if cfg["precision"] != "float32":
            raise ValueError(f"the program runs float32 only, not {cfg['precision']}")
        sc = cfg["scene"]
        self.kind = load_module("scenes", sc["kind"], root)
        self.cam = load_module("cameras", tr["camera"], root)
        # the inputs: made from the seed, handed to both sides
        self.inputs = self.kind.inputs(sc, seed)
        self.aabb = self.inputs["aabb"]
        self.width, self.height = cfg["width"], cfg["height"]
        self.bounces = cfg["bounces"]
        self.modes = tr.get("modes")
        self.period = tr["period"]
        anim = tr.get("animate")
        argv = ["--type", cfg["build"]["type"], "--tracer", cfg["build"]["tracer"],
                "--width", str(self.width), "--height", str(self.height),
                "--bounces", str(self.bounces), "--device", str(self.device)]
        if anim:
            argv.append("--animate")
            if anim.get("refit"):
                argv += ["--refit", "--refit-interval", str(anim["refit_interval"]),
                         "--refit-bound", str(anim["refit_bound"])]
        with contextlib.redirect_stdout(sys.stderr):
            self.prog = self.kind.Program(sc, self.inputs, argv, self.device)
        sampler = Sampler(seed, HIT_SAMPLES)
        self.recorders = {k: Recorder(v, "shadow" in k, sampler)
                          for k, v in self.prog.tracers.items()}
        self.gen = torch.Generator(device=self.device)
        self.anim = anim
        # per-step records
        self.build_ms: List[float] = []
        self.rays: List[int] = []
        self.last = time.perf_counter()

    # -- the loop's pieces ---------------------------------------------------

    def camera(self, pos: int) -> dict:
        return self.cam.pose(*self.aabb, pos, self.period)

    def anim_time(self, pos: int) -> Optional[float]:
        return None if not self.anim else pos * self.anim["dt"]

    def _span(self, name: str):
        if self.trace:
            return torch.profiler.record_function(tracefold.SPAN_PREFIX + name)
        return contextlib.nullcontext()

    def step(self, k: int) -> List[float]:
        """Camera step ``k`` of the loop: the animation and build where the
        cell animates, then each image (one path-traced frame, or each
        render mode in turn) with its read-back to the host. Returns each
        image's wall time, measured from the end of the image before, and
        keeps the images in ``self.images``."""
        from tpu_raytracing_torch.scene import camera as cam
        from tpu_raytracing_torch.trace import pathtrace, render

        prog = self.prog
        pos = k % self.period
        host_cam = self.camera(pos)
        times: List[float] = []
        self.images = {}
        kinds = [None] if self.modes is None else list(self.modes)
        for i, mode in enumerate(kinds):
            with self._span("frame"):
                if i == 0:
                    if self.anim:
                        with self._span("build"):
                            self.build_ms.append(prog.step(self.anim_time(pos)))
                    cam_dev = cam.camera_to_device(cam.Camera(
                        position=host_cam["position"], w=host_cam["w"], u=host_cam["u"],
                        v=host_cam["v"], max_depth=float(host_cam["max_depth"])), self.device)
                if mode is None:
                    self.gen.manual_seed(sub_seed(self.seed, 1, pos))
                    with self._span("path_trace"):
                        img, rays_traced = pathtrace.path_trace(
                            prog.trav, prog.packed, prog.dev_scene, cam_dev, self.width,
                            self.height, num_bounces=self.bounces, generator=self.gen,
                            **self.recorders)
                    with self._span("readback"):
                        img = (img * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
                        self.rays.append(int(rays_traced))
                else:
                    with self._span("render_frame"):
                        img_dev, tests_dev = render.render_frame(
                            prog.trav, prog.packed, prog.dev_scene, cam_dev, self.width,
                            self.height, mode, tracer=self.recorders["tracer"])
                    with self._span("readback"):
                        img = img_dev.cpu().numpy()
                        int(tests_dev)
                self.images[mode] = img
            now = time.perf_counter()
            times.append(now - self.last)
            self.last = now
        return times

    def setting(self) -> dict:
        """What the reference is handed: the same inputs as the program, and
        the scene kind's reference side, made on a given device."""
        kind, inputs = self.kind, self.inputs
        return dict(reference=lambda device: kind.Reference(inputs, device),
                    width=self.width, height=self.height, bounces=self.bounces,
                    albedo=inputs["material"]["diffuse"], material=inputs["material"],
                    light=inputs["light"])

    def free(self) -> None:
        for name in ("prog", "recorders", "images"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: Optional[float] = None, root: Path = REPO, overrides=None,
             control_dtype=None) -> dict:
    """One run of a cell; returns the contract's result object (with
    ``checks`` last) and, under ``"_readings"``, the compared numbers and,
    with ``control_dtype``, the control's."""
    t0 = time.perf_counter() if t_process is None else t_process
    resolved = resolve(workload, root)
    cell = Cell(resolved, seed, device, trace, overrides)
    tr = cell.traffic
    is_cuda = cell.device.type == "cuda"

    # warm-up: the steps the window will run, then back to set-up's state
    for k in range(tr["warm_steps"]):
        cell.step(k)
    cell.prog.reseed()
    sync(device)
    setup_s = time.perf_counter() - t0

    # the capture steps: the first occurrence, after any profiled stretch,
    # of cycle positions drawn from the seed
    rng = np.random.default_rng(sub_seed(seed, 2))
    capture_pos = set(rng.choice(tr["capture_span"], tr["captures"], replace=False).tolist())
    profile_steps = tr["profile_steps"] if trace else 0
    captures: List[dict] = []
    times: List[float] = []
    live_steps: List[list] = []
    # the build times and ray counts of the counted period
    counted_build_ms: List[float] = []
    counted_rays: List[int] = []
    failed = 0
    prof = None
    cell.build_ms.clear()
    cell.rays.clear()
    sync(device)
    cell.last = t_start = time.perf_counter()
    k = 0
    while True:
        if trace and k == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if is_cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        pos = k % cell.period
        capturing = k >= profile_steps and pos in capture_pos
        counting = trace and cell.period <= k < cell.period + profile_steps
        calls: list = []
        for r in cell.recorders.values():
            r.capture = calls if capturing else None
            r.live = [] if counting else None
        built, traced = len(cell.build_ms), len(cell.rays)
        try:
            times += cell.step(k)
        except RuntimeError as exc:
            failed += 1
            print(f"frame {k} failed: {exc}", file=sys.stderr)
            cell.last = time.perf_counter()
        if counting:
            live_steps.append({n: r.live for n, r in cell.recorders.items()})
            counted_build_ms += cell.build_ms[built:]
            counted_rays += cell.rays[traced:]
        if capturing:
            capture_pos.discard(pos)
            captures.append(dict(
                kind="path" if cell.modes is None else "modes", pos=pos,
                time=cell.anim_time(pos), camera=cell.camera(pos),
                gen_seed=sub_seed(seed, 1, pos), calls=calls,
                image=cell.images.get(None), images={m: v for m, v in cell.images.items()
                                                     if m is not None}))
        if prof is not None and k == profile_steps - 1:
            sync(device)
            prof.__exit__(None, None, None)
        k += 1
        # the window runs on, whole frames counted, until every capture
        # step has come: on a slow host a short window would judge nothing
        if (cell.last - t_start >= seconds and not capture_pos
                and (not trace or k >= cell.period + profile_steps)):
            break
    window_s = cell.last - t_start
    for r in cell.recorders.values():
        r.capture = r.live = None
    sync(device)
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    # the per-layer readings need the trace and the program's counters only
    folded = tracefold.fold(tracefold.profiler_events(prof)) if prof is not None else {}
    live = {name: [int(n) for step in live_steps for n in step[name]]
            for name in (live_steps[0] if live_steps else {})}
    images_per_step = 1 if cell.modes is None else len(cell.modes)
    kind = torch.cuda.get_device_name(0) if is_cuda else "cpu"
    ctx = dict(folded=folded, build_ms=counted_build_ms, rays=counted_rays, live=live,
               counted_steps=len(live_steps), images_per_step=images_per_step,
               **cell.inputs["counts"])
    setting = cell.setting()
    forbidden = forbidden_loaded()
    cell.free()

    # the comparison, with the program's state freed
    for cap in captures:
        cap["pixels"] = torch.as_tensor(np.random.default_rng(
            sub_seed(seed, 3, cap["pos"])).choice(cell.width * cell.height, PIXEL_SAMPLES,
                                                  replace=False))
    complete = len(captures) == tr["captures"]
    t_judge = time.perf_counter()
    readings = judge.judge(captures, setting, cell.device) if complete else {}
    judge_s = time.perf_counter() - t_judge
    control = (judge.judge(captures, setting, cell.device, dtype=control_dtype)
               if complete and control_dtype is not None else None)
    limits = resolved["limits"]
    correct = complete and failed == 0 and judge.verdict(readings, limits)

    metrics = {}
    if not trace:
        stats = frame_stats(times, window_s) if times else {}
        values = dict(setup_s=setup_s, peak_mem_gib=peak / 2**30, **stats)
        for m in resolved["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        for m in resolved["per_layer"]:
            v = load_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    dev = dict(platform="gpu" if is_cuda else "cpu", kind=kind, count=1,
               memory_peak_bytes=int(peak))
    result = dict(correct=bool(correct), attempted=len(times) + failed, failed=failed,
                  metrics=metrics, device=dev)
    if trace and folded:
        dev.update(busy_s=folded["busy_us"] / 1e6, window_s=folded["window_us"] / 1e6)
        result["breakdown"] = dict(
            device_ops=[[n[:NAME_CHARS], us / 1e6] for n, us in folded["device_ops"]],
            idle_gaps=[[n[:NAME_CHARS], us / 1e6] for n, us in folded["idle_gaps"]])
    result["checks"] = {name: dict(value=readings.get(name), limit=limit)
                        for name, limit in limits.items()}
    if not complete:
        result["checks"]["captures"] = dict(value=len(captures), limit=tr["captures"])
    result["_readings"] = dict(program=readings, control=control, forbidden=forbidden,
                               frames=len(times), window_s=window_s, setup_s=setup_s,
                               judge_s=judge_s)
    return result
