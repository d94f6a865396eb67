"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference.py``), on samples drawn from the
seed.

The numbers compared:

- ``hit_miss``: the share of sampled closest-hit rays (live rays of the
  traversal calls the window made on its capture frames) whose hit
  disagrees with the reference's: a hit where it finds none or none where
  it finds one, or a distance off by more than ``T_REL`` of the
  reference's plus ``T_ABS``.
- ``shadow_miss``: the share of sampled any-hit rays whose verdict
  (occluded or not) disagrees.
- ``pixel_miss``: the share of sampled pixels of the read-back images
  with a channel more than ``PIXEL_LEVELS`` steps of 255 from the
  reference's value, truncated as the program's byte cast truncates;
  taken per kind of image (the path-traced frame, or each render mode)
  over the capture frames, and the worst kind's share reported, so that a
  fault in one mode's shading is not diluted by the others.
- ``count_form`` (render modes only): the number of sampled pixels of the
  two test-count modes whose colour breaks the mode's form (box tests:
  red 0 and green = blue; triangle tests: red = blue, and red the
  truncation of 100/255 of the same fraction as green). The counts
  themselves are the program's own tally of its tree's work; no tree-free
  reference exists for them.

The reference casts every ray against every triangle of the frame's
geometry (moved by the animation where the cell animates it), so it also
judges the tree built from that geometry. The geometry of a capture, and
the normals of its hit ids, come from the scene kind's reference side
(``setting["reference"]``, see ``harness.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from rtbench import reference as ref

T_REL = 1e-5
T_ABS = 1e-4
PIXEL_LEVELS = 2


def judge_hits(calls: List[dict], caster: ref.Caster, answer=None) -> Dict[str, list]:
    """Per sampled live ray, whether the answer disagrees with the
    reference's: {"closest": [bool...], "any": [bool...]}. ``answer`` (a
    Caster) stands in for the program's recorded hits (the control)."""
    out = {"closest": [], "any": []}
    for c in calls:
        live = c["active"]
        o, d, tmin, tmax = (c[k][live] for k in ("o", "d", "tmin", "tmax"))
        if o.shape[0] == 0:
            continue
        if c["any_hit"]:
            want = caster.occluded(o, d, tmin, tmax)
            got = c["hit"][live] if answer is None else answer.occluded(o, d, tmin, tmax)
            out["any"].append((want != got).cpu())
        else:
            hit_r, t_r, _, _, _ = caster.closest(o, d, tmin, tmax)
            if answer is None:
                hit_p, t_p = c["hit"][live], c["t"][live]
            else:
                hit_p, t_p, _, _, _ = answer.closest(o, d, tmin, tmax)
            far = (t_p - t_r).abs() > T_REL * t_r.abs() + T_ABS
            out["closest"].append(((hit_p != hit_r) | (hit_r & far)).cpu())
    return out


def pixel_off(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per pixel, whether a channel of the byte image ``got`` lies more
    than PIXEL_LEVELS from the truncation of the reference's ``want``."""
    w = torch.trunc(torch.nan_to_num(want, nan=0.0)).clamp(0.0, 255.0)
    return ((got.to(torch.float32) - w).abs() > PIXEL_LEVELS).any(dim=-1)


def count_form_breaks(mode: int, rgba: torch.Tensor) -> int:
    """Sampled pixels of a test-count mode whose colour breaks its form."""
    r, g, b = (rgba[:, i].to(torch.int64) for i in range(3))
    if mode == ref.BOX_TESTS:
        bad = (r != 0) | (g != b)
    else:
        lo = (g * 100) // 255
        hi = ((g + 1) * 100) // 255
        bad = (r != b) | (r < lo) | (r > hi)
    return int(bad.sum())


def worst_share(flags_by_kind: dict) -> float:
    """The largest share over the kinds of image (nan where none)."""
    shares = [share(f) for f in flags_by_kind.values()]
    return max(shares) if shares else float("nan")


def share(flags: list) -> float:
    if not flags:
        return float("nan")
    allf = torch.cat(flags)
    return float(allf.float().mean()) if allf.numel() else float("nan")


def judge(captures: List[dict], setting: dict, device, dtype=None) -> Dict[str, float]:
    """The compared numbers over every capture. ``setting`` holds what
    both sides were handed (the scene kind's reference side, the scene
    constants, image size, bounces). ``dtype`` set: the control, the
    reference in that precision in the program's place."""
    scene = setting["reference"](device)
    flags = {"closest": [], "any": []}
    pix: Dict[object, list] = {}
    breaks = 0
    cached = {}
    for cap in captures:
        key = cap.get("time")
        if key not in cached:
            cached.clear()
            caster, normals = scene.geometry(key)
            cached[key] = (caster, normals,
                           None if dtype is None else scene.geometry(key, dtype)[0])
        caster, normals, answer = cached[key]
        h = judge_hits(cap["calls"], caster, answer)
        flags["closest"] += h["closest"]
        flags["any"] += h["any"]
        pixels = cap["pixels"].to(device)
        w, hgt = setting["width"], setting["height"]
        if cap["kind"] == "path":
            uni = ref.path_uniforms(cap["gen_seed"], w * hgt, setting["bounces"], device)
            want = ref.path_trace_pixels(caster, normals, setting["albedo"], setting["light"],
                                         cap["camera"], w, hgt, setting["bounces"], uni,
                                         pixels) * 255.0
            if answer is None:
                got = torch.as_tensor(cap["image"].reshape(-1, 3)[pixels.cpu().numpy()],
                                      device=device)
            else:
                got = torch.trunc(ref.path_trace_pixels(
                    answer, normals, setting["albedo"], setting["light"], cap["camera"], w,
                    hgt, setting["bounces"], uni, pixels) * 255.0).clamp(0, 255)
            pix.setdefault(None, []).append(pixel_off(got, want).cpu())
        else:
            modes = sorted(cap["images"])
            colour_modes = [m for m in modes if m not in ref.COUNT_MODES]
            want = ref.mode_colours(caster, normals, setting["material"], setting["light"],
                                    cap["camera"], w, hgt, pixels, colour_modes)
            if answer is not None:
                got_all = ref.mode_colours(answer, normals, setting["material"],
                                           setting["light"], cap["camera"], w, hgt, pixels,
                                           colour_modes)
            idx = pixels.cpu().numpy()
            for m in modes:
                img = torch.as_tensor(cap["images"][m].reshape(-1, 4)[idx], device=device)
                if m in ref.COUNT_MODES:
                    if answer is None:
                        breaks += count_form_breaks(m, img)
                    continue
                got = img if answer is None else torch.trunc(got_all[m]).clamp(0, 255)
                pix.setdefault(m, []).append(pixel_off(got, want[m]).cpu())
    out = dict(hit_miss=share(flags["closest"]), shadow_miss=share(flags["any"]),
               pixel_miss=worst_share(pix))
    if any(c["kind"] == "modes" for c in captures):
        out["count_form"] = float(breaks)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and within its limit."""
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not np.isfinite(v) or v > limit:
            return False
    return True
