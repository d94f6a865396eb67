"""The sharded legs of ``tests/test_torch_parallel.py``, run in one rank
of a gloo world on the CPU (or in the test process as a world of one).

    python tests/torch_parallel_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR

Every rank runs each sharded function of ``tpu_raytracing_torch.parallel``
on the same inputs (triangles and bounce uniforms from INPUTS.npz, the
rest from fixed seeds) and saves what it returned to OUT_DIR/rank{RANK}.pt.
Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_raytracing_torch.bvh import bucket, grid, lbvh, tlas
from tpu_raytracing_torch.parallel import flagship, render
from tpu_raytracing_torch.scene import camera as cam
from tpu_raytracing_torch.scene import procedural
from tpu_raytracing_torch.scene.types import scene_to_device
from tpu_raytracing_torch.trace import split_trace
from tpu_raytracing_torch.trace.instanced_split import build_instanced_split
from tpu_raytracing_torch.trace.modes import RenderType
from tpu_raytracing_torch.trace.ray import generate_primary_rays
from tpu_raytracing_torch.trace.traverse import pack_bvh, pack_pairs

# __graft_entry__.dryrun_multichip's shapes: soup(512), 32 x 8n pixels (n =
# 4, the largest world), 4 instances; the instanced split tracer gets 32 x 32
# rays (the dryrun's 16 x n meet no triangle of the sparse soup)
W, H = 32, 32
N_INST = 4
TLS = RenderType.TEXTURE_LIT_SHADOWS


def inputs(triangles: np.ndarray) -> dict:
    """The replicated structures every rank builds from the same triangles."""
    scene = procedural.random_triangle_soup(512, seed=3)
    tris = torch.from_numpy(triangles)
    bvh, pairs = lbvh.build_lbvh(tris)
    views, packed, _ = bucket.emit_split_views(bucket.split_front(tris),
                                               leaf_width=split_trace.LEAFW)
    tf = np.tile(np.eye(3, 4, dtype=np.float32), (N_INST, 1, 1))
    tf[:, :, 3] = np.linspace(-2.0, 2.0, N_INST)[:, None] * np.array([1.0, 0.3, 0.0], np.float32)
    blas_lo = tris.reshape(-1, 3).amin(dim=0)
    blas_hi = tris.reshape(-1, 3).amax(dim=0)
    camera = cam.camera_to_device(cam.initialise_camera(scene.aabb_min, scene.aabb_max), "cpu")
    tf2 = np.stack([np.concatenate([np.eye(3), [[2.5 * i], [0.0], [0.0]]], axis=1)
                    for i in range(N_INST)]).astype(np.float32)
    cam2 = cam.camera_to_device(cam.initialise_camera(
        scene.aabb_min, scene.aabb_max + np.array([2.5 * N_INST, 0, 0], np.float32)), "cpu")
    return dict(
        scene=scene_to_device(scene, "cpu"), camera=camera, trav=pack_bvh(bvh),
        pairs=pack_pairs(pairs), views=views, packed=packed,
        ias=build_instanced_split(views, packed, blas_lo, blas_hi, torch.from_numpy(tf)),
        inst_rays=generate_primary_rays(camera, W, H),
        grid=grid.build_grid(packed.rows, packed.rows.shape[0]),
        inst_tf=torch.from_numpy(tf2), inst_as=tlas.build_instanced(bvh, torch.from_numpy(tf2)),
        inst_as_rays=generate_primary_rays(cam2, 32, 16))


def with_uniforms(uniforms, fn, *args, **kwargs):
    """``fn`` with each ``torch.rand`` call answered by the next of
    ``uniforms`` (the reference's per-bounce draws)."""
    draws = iter(uniforms)
    orig = torch.rand
    torch.rand = lambda *a, **k: torch.from_numpy(np.array(next(draws)))
    try:
        return fn(*args, **kwargs)
    finally:
        torch.rand = orig


def run_legs(mesh, triangles: np.ndarray, uniforms) -> dict:
    """Every sharded function on its inputs; returns their results."""
    s = inputs(triangles)
    out = {}
    out["megakernel"] = render.render_frame_sharded(
        mesh, s["trav"], s["pairs"], s["scene"], s["camera"], W, H, TLS)
    out["auto"] = render.render_frame_auto_sharded(
        mesh, s["trav"], s["pairs"], s["scene"], s["camera"], W, H, RenderType.DEPTH)
    out["split_render"] = flagship.render_frame_sharded_split(
        mesh, s["views"], s["packed"], s["scene"], s["camera"], W, H, TLS, k=128)
    out["split_path"] = with_uniforms(
        uniforms, flagship.path_trace_sharded, mesh, s["views"], s["packed"], s["scene"],
        s["camera"], W, H, num_bounces=1, k=128)
    out["grid_path"] = with_uniforms(
        uniforms, flagship.path_trace_sharded, mesh, s["grid"], s["packed"], s["scene"],
        s["camera"], W, H, num_bounces=1, k=128, tracer_kind="grid")
    out["inst_split"] = flagship.trace_instanced_split_sharded(mesh, s["ias"], s["inst_rays"],
                                                               k_slots=4)
    out["inst"] = flagship.trace_instanced_sharded(mesh, s["inst_as"], s["pairs"],
                                                   s["inst_as_rays"])
    return out


def main(argv) -> None:
    rank, world, port, inputs_path, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.set_num_threads(1)
    data = np.load(inputs_path)
    mesh = render.init_mesh(rank, world, f"tcp://localhost:{port}", device="cpu")
    try:
        out = run_legs(mesh, data["triangles"], [data["u0"], data["u1"]])
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
