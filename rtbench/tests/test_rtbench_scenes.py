"""Scene kinds and cameras are found by name: the terrain kind hands both
sides what the benchmark handed them before it moved into
``scenes/terrain.py``, and a new kind (instances of an icosphere, judged by
the two-level reference caster) and a new camera are taken from new files
alone, in a copy of the benchmark, with no file of it edited."""

import hashlib
import importlib.util
import json
import shutil

import numpy as np
import pytest
import torch

from conftest import REPO, small

from rtbench import harness, judge, reference

KINDS = REPO / "rtbench" / "tests" / "kinds"


def _load(path):
    spec = importlib.util.spec_from_file_location("rtbench_test_kind", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

# sha256 of the terrain's triangles as the benchmark made them before the
# terrain became a scene kind: (asked triangles, seed) -> (made, digest)
TERRAIN_SHA256 = {
    (2000, 0): (1922, "c83c1f4dc77189cc9658959116ffefc1063e48dec4cb3525773a67e7f13b1ed4"),
    (2000, 7): (1922, "69bb8cc68c5b1591f6029987dbee54f509877fd20707a8d9bbc150b8cd10e403"),
    (1_000_000, 0): (999_698,
                     "b87c6ee5c57ccc915af7005380c8aba03f051ce7b54938b5678b67095fcd2796"),
    (1_000_000, 7): (999_698,
                     "3b8ae7c7fb8cca9b11c07d8b983fb14178a12f3db31f7fae0866a2dbd284175f"),
}


@pytest.mark.parametrize("asked,seed", sorted(TERRAIN_SHA256))
def test_terrain_kind_triangles_unchanged(asked, seed):
    kind = harness.load_module("scenes", "terrain")
    scene = dict(harness.resolve("terrain1m-split.orbit")["config"]["scene"], triangles=asked)
    inputs = kind.inputs(scene, seed)
    tris = inputs["triangles"]
    made, digest = TERRAIN_SHA256[(asked, seed)]
    assert tris.shape == (made, 3, 3) and tris.dtype == np.float32
    assert hashlib.sha256(tris.tobytes()).hexdigest() == digest
    assert inputs["counts"] == {"num_triangles": made}
    assert np.array_equal(inputs["aabb"][0], tris.reshape(-1, 3).min(0))
    assert np.array_equal(inputs["aabb"][1], tris.reshape(-1, 3).max(0))


# the app's flags as the harness gave them before the terrain became a
# scene kind, for the split refit cell at ``conftest.small``'s size
OLD_ARGV = ["--scene", "terrain:2000", "--type", "bottom-up", "--tracer", "split",
            "--width", "32", "--height", "32", "--bounces", "2", "--device", "cpu",
            "--pairs", "--animate", "--refit", "--refit-interval", "3", "--refit-bound", "1.3"]


def test_terrain_kind_parses_the_same_flags():
    """The kind's program set-up hands the app the flags it had before."""
    from tpu_raytracing_torch.app import main as app

    workload = "terrain1m-split.animate-refit"
    cell = harness.Cell(harness.resolve(workload), 5, "cpu", False, overrides=small(workload))
    assert vars(cell.prog.args) == vars(app.parse_cmd(OLD_ARGV))
    assert cell.prog.sched is not None


def test_aerial_orbit_is_found_by_name():
    cam = harness.load_module("cameras", "aerial_orbit")
    lo, hi = np.array([-50.0, -9.0, -50.0]), np.array([50.0, 9.0, 50.0])
    for step in (0, 5, 63):
        got = cam.pose(lo, hi, step, 64)
        old = reference.CAMERAS["aerial_orbit"](lo, hi, step, 64)
        for key in ("position", "u", "v", "w", "max_depth"):
            assert np.array_equal(got[key], old[key])


# ---------------------------------------------------------------------------
# The two-level caster against the flat caster over the expanded triangles
# ---------------------------------------------------------------------------


def _instanced_scene(seed: int):
    """An icosphere (80 triangles) under 6 transforms: rotations, uniform
    and non-uniform scales, a mirror, translations; rays from around and
    inside the instances, most aimed near an instance, some along the
    axes."""
    rng = np.random.default_rng(seed)
    obj = torch.as_tensor(_load(KINDS / "icospheres.py").icosphere(1, rng))
    xs = []
    for k in range(6):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        scale = np.diag(rng.uniform(0.5, 2.0, 3)) if k % 2 else np.eye(3) * rng.uniform(0.5, 2)
        a = q @ scale
        if k == 5:
            a = a @ np.diag([-1.0, 1.0, 1.0])
        xs.append(np.concatenate([a, rng.uniform(-4, 4, (3, 1))], 1))
    x = torch.as_tensor(np.stack(xs), dtype=torch.float32)
    world = torch.einsum("iab,tvb->itva", x[:, :, :3], obj) + x[:, None, None, :, 3]
    n = 600
    o = torch.as_tensor(rng.uniform(-8, 8, (n, 3)), dtype=torch.float32)
    d = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    # most rays aimed near an instance's centre
    aim = x[torch.as_tensor(rng.integers(0, 6, n)), :, 3] + torch.as_tensor(
        rng.normal(0, 0.8, (n, 3)), dtype=torch.float32)
    d[100:] = (aim - o)[100:]
    d[:40] = torch.eye(3)[torch.as_tensor(rng.integers(0, 3, 40))] * \
        torch.as_tensor(rng.choice([-1.0, 1.0], (40, 1)), dtype=torch.float32)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    tmin = torch.full((n,), 1e-3)
    tmax = torch.as_tensor(rng.uniform(2, 30, n), dtype=torch.float32)
    return obj, x, world.reshape(-1, 3, 3), (o, d, tmin, tmax)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_level_caster_agrees_with_flat(seed, skip):
    obj, x, world, rays = _instanced_scene(seed)
    flat = reference.Caster(world)
    two = reference.InstancedCaster(obj, x, skip=skip)
    hit_f, t_f, id_f, u_f, v_f = flat.closest(*rays)
    hit_2, t_2, id_2, u_2, v_2 = two.closest(*rays)
    assert hit_f.sum() > 100 and (~hit_f).sum() > 50
    assert torch.equal(hit_f, hit_2)
    h = hit_f
    assert ((t_2[h] - t_f[h]).abs() <= judge.T_REL * t_f[h].abs() + judge.T_ABS).all()
    # where the ids differ, the two-level caster's triangle lies at the
    # flat caster's t too: a tie between two triangles
    o, d, tmin, tmax = rays
    for j in (h & (id_f != id_2)).nonzero().flatten().tolist():
        one = reference.Caster(world[id_2[j]:id_2[j] + 1])
        hit, t, _, _, _ = one.closest(o[j:j + 1], d[j:j + 1], tmin[j:j + 1], tmax[j:j + 1])
        assert hit.item() and abs(t.item() - t_f[j].item()) <= 1e-5 * t_f[j].item() + 1e-4
    assert (h & (id_f != id_2)).sum() <= 2
    same = h & (id_f == id_2)
    assert torch.allclose(u_2[same], u_f[same], atol=1e-3)
    assert torch.allclose(v_2[same], v_f[same], atol=1e-3)
    assert torch.equal(flat.occluded(*rays), two.occluded(*rays))
    # the normals of the hit ids: the world triangles' flat normals
    want = reference.flat_normals(world)[id_f[h]]
    assert torch.allclose(two.normals[id_f[h]], want, atol=1e-5)


def test_instance_boxes_are_the_transformed_vertices():
    obj, x, world, _ = _instanced_scene(4)
    lo, hi = reference.instance_boxes(obj, x)
    verts = world.reshape(x.shape[0], -1, 3)
    assert torch.allclose(lo, verts.amin(1), atol=1e-6)
    assert torch.allclose(hi, verts.amax(1), atol=1e-6)


def test_box_skip_leaves_out_instances():
    """With the skip, rays far from most instances test fewer pairs."""
    obj, x, _, (o, d, tmin, tmax) = _instanced_scene(5)
    two = reference.InstancedCaster(obj, x)
    ray, _, _ = two._pairs(o, d, tmin, tmax)
    assert 0 < ray.shape[0] < o.shape[0] * x.shape[0]


# ---------------------------------------------------------------------------
# A new scene kind and camera as new files only
# ---------------------------------------------------------------------------

WORKLOAD = "spheres8-split.bob"


def _checkout_with_kind(root, kind_source: str):
    shutil.copytree(REPO / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".tmp"))
    before = {p: p.read_bytes() for p in (root / "rtbench").rglob("*") if p.is_file()}
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "rtbench"
    (bench / "scenes" / "icospheres.py").write_text(kind_source)
    shutil.copy(KINDS / "ring_view.py", bench / "cameras" / "ring_view.py")
    cfg = dict(name="spheres8-split", precision="float32",
               scene=dict(kind="icospheres", subdivisions=2, instances=8, ring=3.5,
                          material={"diffuse": [0.6, 0.5, 0.4], "ambient": [0.6, 0.5, 0.4]},
                          light=[3.0, 40.0, -5.0]),
               build={"type": "bottom-up", "tracer": "split"}, width=32, height=32,
               bounces=2)
    (bench / "configs" / "spheres8-split.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "bob.json").write_text(json.dumps(dict(
        camera="ring_view", period=4, animate={"dt": 0.7, "refit": False}, warm_steps=1,
        profile_steps=2, captures=4, capture_span=4)))
    (bench / "limits" / f"{WORKLOAD}.json").write_text(
        json.dumps({"hit_miss": 0.01, "shadow_miss": 0.01, "pixel_miss": 0.01}))
    spec["configs"].append(dict(name="spheres8-split", source="a test", reduced=[],
                                file="rtbench/configs/spheres8-split.json", why="a test"))
    spec["workloads"].append(dict(name=WORKLOAD, config="spheres8-split", traffic="bob",
                                  chips=1, why="a test"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data
    return root


def _run(root):
    return harness.run_cell(WORKLOAD, 2**32 + 41, 0.5, False, device="cpu", root=root)


def test_new_scene_kind_and_camera_as_new_files_only(tmp_path):
    root = _checkout_with_kind(tmp_path / "checkout", (KINDS / "icospheres.py").read_text())
    r = _run(root)
    assert r["correct"], r["checks"]
    program = r["_readings"]["program"]
    assert program["hit_miss"] == 0 and program["shadow_miss"] == 0, program


# the reference alone moves one instance by twice its radius
MOVED = '''

_Sound = Reference


class Reference(_Sound):
    def transforms(self, t):
        x = super().transforms(t)
        x[0, 0, 3] += 2.0 * x[0, 0, 0]
        return x
'''


def test_new_scene_kind_instance_moved_in_reference_fails(tmp_path):
    root = _checkout_with_kind(tmp_path / "checkout",
                               (KINDS / "icospheres.py").read_text() + MOVED)
    r = _run(root)
    assert not r["correct"], r["checks"]
    check = r["checks"]["hit_miss"]
    assert check["value"] > check["limit"], r["checks"]
