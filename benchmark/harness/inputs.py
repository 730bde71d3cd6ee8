"""The inputs of one run, made from the configuration, the mix and the
seed, on the device.

Both sides get these same inputs: the program through its public API
(``port.py``), the reference as plain tensors. The seed places the env
map's sun (unless the mix fixes it with ``env_sun``), starts the trained
parameters off the truth, picks the training run's frames, and picks
which of the window's frames are checked. It changes no size: every seed
renders the same resolution, samples and bounces, and trains the same
parameters.
"""

from __future__ import annotations

import math
import types

import torch

from benchmark.harness.spec import load_module
from benchmark.reference.tracer import camera_distance


class Inputs(types.SimpleNamespace):
    """opts (render settings: the config's with the mix's overrides),
    scene (tensors, the reference's scene layout), tex ((3, T) env texel
    planes), tex_w, tex_h, and what the traffic kind draws for itself
    (``benchmark/kinds/<kind>.py``'s ``draw``)."""


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def gradient_sky(width: int, height: int, gen: torch.Generator,
                 device, sun=None) -> torch.Tensor:
    """(3, H*W) planes of a smooth sky, row-major from the top row: a
    vertical gradient with a horizontal hue swing and a bright sun blob
    (values up to about 20) whose place is drawn from ``gen``, as the
    program's ``texture/procedural.gradient_sky`` draws it from its
    seed, or is ``sun`` = (u, v) where given (the draw is still made, so
    what is drawn after it does not move)."""
    su, sv = torch.rand(2, generator=gen, device=device).tolist()
    su, sv = 0.2 + 0.6 * su, 0.5 + 0.4 * sv
    if sun is not None:
        su, sv = (float(x) for x in sun)
    v = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    u = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    sun = 18.0 * torch.exp(-((u - su) ** 2 + (v - sv) ** 2) / 0.005)
    r = 0.2 + 0.8 * v + 0.1 * torch.sin(2 * math.pi * u) + sun
    g = 0.3 + 0.6 * v + 0.1 * torch.cos(2 * math.pi * u) + sun
    b = (0.5 + 0.5 * v + 0.0 * u) + sun
    return torch.stack([r, g, b]).reshape(3, -1).contiguous()


def scene_tensors(spec: dict, device) -> dict:
    """The configuration's scene as float32 / int64 tensors."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    mats = spec["materials"]
    cam = spec["camera"]
    return {
        "quads": f32([q["v"] for q in spec["quads"]]),
        "quad_material": torch.tensor([q["material"] for q in spec["quads"]],
                                      dtype=torch.int64, device=device),
        "centers": f32([s["center"] for s in spec["spheres"]]),
        "radii": f32([s["radius"] for s in spec["spheres"]]),
        "sphere_material": torch.tensor(
            [s["material"] for s in spec["spheres"]], dtype=torch.int64,
            device=device),
        "materials": {k: f32([m[k] for m in mats]) for k in mats[0]},
        "camera": {"position": [float(p) for p in cam["position"]],
                   "fov_degrees": float(cam["fov_degrees"]),
                   "distance": camera_distance(cam["fov_degrees"]),
                   "forward_z": float(cam["forward_z"])},
    }


def make_inputs(cell, seed: int, device) -> Inputs:
    """Every input of one run of ``cell`` from ``seed``: the env map, the
    scene, then the traffic kind's own draws."""
    opts = dict(cell.render)
    if opts["env_mode"] != "equirect" or opts["env_sampling"] != "stochastic":
        raise ValueError("the benchmark renders an equirect env map with "
                         "stochastic sampling")
    gen = generator(seed, device)
    env = cell.config["env"]
    tex = gradient_sky(env["width"], env["height"], gen, device,
                       cell.traffic.get("env_sun"))
    scene = scene_tensors(cell.config["scene"], device)
    kind = load_module("kinds", cell.traffic["kind"])
    return Inputs(opts=opts, scene=scene, tex=tex, tex_w=env["width"],
                  tex_h=env["height"],
                  **kind.draw(cell, gen, device, scene, tex))
