"""The system under test, through its public API: the one module of the
benchmark that imports the program (``cpuperformanceraytracer_tpu_torch``).

It hands the program the benchmark's inputs (scene, camera, env texels,
trained parameters) as the program's own types and builds the two entry
points the window drives: ``OfflineRenderer.step()`` for a progressive
frame, and one replay of ``make_train_step_k``'s K steps for a training
dispatch; the program's own checkpoint save of a progressive render; and
a training problem's gradient through the call a training step makes.

A cell of several ranks (``harness/world.py``) joins each rank to its
world through the program's own ``init_distributed`` and ``make_mesh``,
and hands the mesh to ``OfflineRenderer``, which then renders and
accumulates the rank's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.core.vecmath import Vec3
from cpuperformanceraytracer_tpu_torch.diff.grad import (
    fixed_quad_table,
    image_loss,
    render_for_params,
    value_and_grad,
)
from cpuperformanceraytracer_tpu_torch.diff.inverse import (
    InverseProblem,
    make_train_step_k,
)
from cpuperformanceraytracer_tpu_torch.io import checkpoint
from cpuperformanceraytracer_tpu_torch.kernels._build import load_library
from cpuperformanceraytracer_tpu_torch.parallel.mesh import (
    AXES,
    init_distributed,
    make_mesh,
)
from cpuperformanceraytracer_tpu_torch.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu_torch.scene.camera import make_camera
from cpuperformanceraytracer_tpu_torch.scene.types import (
    Materials,
    Quads,
    Scene,
    Spheres,
)
from cpuperformanceraytracer_tpu_torch.texture.texture import Texture

# the program's kernels: its CUDA ones
BACKEND = "cuda"


def load_kernels() -> None:
    """Build, or load where built, the program's kernel library in this
    process, so that ranks started after it only load it."""
    if BACKEND == "cuda":
        load_library()


def join_world(rank: int, size: int, address: str, backend: str,
               shape: tuple, device):
    """This process as rank ``rank`` of a world of ``size`` ranks whose
    store rank 0 serves at ``address`` ("host:port"), over ``backend``;
    returns the rank's mesh of ``shape`` (px, spp) on ``device``. Every
    rank calls it."""
    init_distributed(address, size, rank, backend)
    return make_mesh(shape, AXES, device=device)


def leave_world() -> None:
    """End this process's part in its world, where it has one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _vec3(a: torch.Tensor) -> Vec3:
    return Vec3(*(c.contiguous() for c in a.unbind(-1)))


def program_scene(inputs, device):
    """(Scene, Camera, Texture) of the program from the inputs."""
    s = inputs.scene
    q = s["quads"]
    quads = Quads(*(_vec3(q[:, i]) for i in range(4)),
                  material=s["quad_material"])
    spheres = Spheres(center=_vec3(s["centers"]), radius=s["radii"],
                      material=s["sphere_material"])
    m = s["materials"]
    mats = Materials(**{k: _vec3(v) if v.dim() == 2 else v
                        for k, v in m.items()})
    cam = s["camera"]
    camera = make_camera(tuple(cam["position"]), cam["fov_degrees"],
                         cam["forward_z"], device=device)
    tex = Texture(*(p.contiguous() for p in inputs.tex), inputs.tex_w,
                  inputs.tex_h)
    return Scene(quads=quads, spheres=spheres, materials=mats), camera, tex


def render_config(opts: dict, warmup_frames: int = 0):
    fields = ("width", "height", "spp", "bounces", "env_mode",
              "env_sampling", "env_flip_xz", "unit_vector_sampler", "jitter",
              "rng", "roulette")
    return RenderConfig(**{k: opts[k] for k in fields},
                        ambient=tuple(opts["ambient"]),
                        warmup_frames=warmup_frames,
                        backend=BACKEND).validate()


class Progressive:
    """One viewer's progressive render: ``call()`` enqueues the next
    frame (``OfflineRenderer.step()``); ``accum`` is the (3, H, W)
    accumulator it updates in place, or under a ``mesh`` this rank's rows
    of it."""

    steps_per_call = 1

    def __init__(self, inputs, traffic, device, mesh=None):
        scene, camera, tex = program_scene(inputs, device)
        cfg = render_config(inputs.opts, traffic["warmup_calls"])
        self.renderer = OfflineRenderer(cfg, tex, scene=scene, camera=camera,
                                        device=device, silent=True, mesh=mesh)

    def warm(self):
        """The renderer's own warm-up: frames into a scratch accumulator."""
        self.renderer.warmup()

    def call(self):
        self.renderer.step()

    @property
    def accum(self) -> torch.Tensor:
        return self.renderer.local

    @property
    def writes(self) -> bool:
        """True where this rank writes the render's files: rank 0 of a
        mesh, or the render alone."""
        mesh = self.renderer.mesh
        return mesh is None or mesh.rank == 0

    def save(self, path: str) -> None:
        """The program's checkpoint of the render to ``path``: the
        renderer's own ``save_checkpoint(path)`` where it has one, else
        ``io/checkpoint.save_checkpoint`` of its accumulator, frame and
        config, as ``OfflineRenderer.run`` saves. Under a mesh every rank
        calls it: the accumulator is assembled from every rank's rows (a
        collective), and rank 0 writes it."""
        r = self.renderer
        save = getattr(r, "save_checkpoint", None)
        if save is not None:
            save(path)
            return
        accum = r.accum
        if self.writes:
            checkpoint.save_checkpoint(path, accum, r.frame, r.cfg)


def train_problem(inputs, device) -> InverseProblem:
    """The program's inverse-render problem: its scene, camera, texture
    and config from the inputs, and the target it renders at the inputs'
    ``target_frame``."""
    scene, camera, tex = program_scene(inputs, device)
    cfg = render_config(inputs.opts)
    with torch.no_grad():
        target = render_for_params({}, scene, camera, tex, cfg,
                                   inputs.target_frame)
    return InverseProblem(scene, camera, tex, cfg, target)


class Train:
    """Inverse-rendering jobs with Adam: ``call()`` enqueues one dispatch of
    K training steps (one replay of the captured graph on the card; the
    first call also captures it). Every ``dispatches_per_job`` calls a
    new job starts from the same parameters: they and Adam's state are
    put back in place, as ``make_train_step_k`` puts them back after its
    capture, and the graph is reused. ``losses`` holds the (K,) losses of
    the last call; ``problem`` is its ``train_problem``."""

    def __init__(self, inputs, traffic, device):
        self.problem = train_problem(inputs, device)
        self.start = {k: v.detach().clone() for k, v in inputs.params0.items()}
        self.params = {k: v.clone().requires_grad_()
                       for k, v in self.start.items()}
        self.optimizer = torch.optim.Adam(
            list(self.params.values()), lr=traffic["lr"], eps=traffic["eps"],
            capturable=device.type == "cuda")
        self.k = traffic["steps_per_dispatch"]
        self.steps_per_call = self.k
        self.per_job = traffic["dispatches_per_job"]
        self.step_k = make_train_step_k(self.problem, self.optimizer, self.k,
                                        resample_frames=True)
        self.next_frame = inputs.frame0
        self.calls = 0
        self.losses = None

    def _new_job(self):
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(self.start[name])
                for v in self.optimizer.state[p].values():
                    v.zero_()

    def call(self):
        if self.calls and self.calls % self.per_job == 0:
            self._new_job()
        self.losses = self.step_k(self.params, self.next_frame)
        self.next_frame += self.k
        self.calls += 1


def gradients(problem, params: dict, frame: int) -> tuple:
    """(loss, {name: gradient}) of ``problem``'s L2 loss at ``params`` and
    ``frame``, through the call ``make_train_step`` makes (the program's
    ``render_for_params`` with its own config and the scene's fixed quad
    table, then ``image_loss``): the kernels of a training step (A to D),
    called eagerly rather than replayed from the graph."""
    quad_tbl = fixed_quad_table(problem.scene)
    return value_and_grad(
        lambda p: image_loss(render_for_params(
            p, problem.scene, problem.camera, problem.texture, problem.cfg,
            frame, quad_tbl), problem.target), params)
