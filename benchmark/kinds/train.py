"""The ``train`` traffic kind: inverse-rendering jobs with Adam, one
dispatch of ``make_train_step_k``'s K steps a call.

Its own inputs are the trained parameters' start, off the truth by the
seed, the frame the target is rendered at and the first step's frame.
The set-up's first dispatch, the window's own call on the same state,
captures the graph and is the one judged: the reference renders the
target and follows its K steps with autograd and Adam
(``check.reference_train``), and ``check.compare_train`` compares the
first step's loss and each parameter leaf's change. After the window the
program's gradient of that first step's loss (``port.gradients``: the
call a step makes, run eagerly) is compared with the reference's first
gradient (``grad_gap``; the reference takes it in float64 too, to find
the leaves that swing with single bright paths). A step renders the
mix's ``spp`` samples.
"""

from __future__ import annotations

import torch

from benchmark.harness import check, window

# the numbers the cell's checks limit
COMPARES = ("loss_gap", "change_gap", "grad_gap")


def draw(cell, gen: torch.Generator, device, scene: dict,
         tex: torch.Tensor) -> dict:
    """The parameters' start (albedo up, sphere centers moved either
    way, every texel scaled, each by the mix's offset times a draw), the
    target's frame, and the first step's frame after it."""
    off = cell.traffic["start_offsets"]
    nm = scene["materials"]["albedo"].shape[0]
    ns = scene["centers"].shape[0]

    def uniform(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    sign = torch.where(uniform(ns, 3) < 0.5, -1.0, 1.0)
    params0 = {
        "albedo": scene["materials"]["albedo"]
        + off["albedo"] * uniform(nm, 3, lo=0.5, hi=1.5),
        "sphere_centers": scene["centers"]
        + off["sphere_centers"] * sign * uniform(ns, 3, lo=0.5, hi=1.5),
        "env_rgb": (tex * (1.0 + off["env_rgb"]
                           * uniform(*tex.shape, lo=-1.0, hi=1.0))).t()
        .contiguous(),
    }
    target_frame = int(torch.randint(0, 1 << 20, (1,), generator=gen,
                                     device=device).item())
    return {"params0": params0, "target_frame": target_frame,
            "frame0": target_frame + 1}


def launches(opts: dict, traffic: dict) -> dict:
    """{work file: launches a dispatch}: A, B, C and D once a sample of
    each of the K steps."""
    n = traffic["steps_per_dispatch"] * opts["spp"]
    return {"kernel_a": n, "kernel_b": n, "kernel_c": n, "kernel_d": n}


class Session(window.Session):
    """The program's training loop with its first dispatch run (which
    captures the graph) and its losses and parameters kept; its problem
    (scene, texture, target) outlives the loop for the gradient's check."""

    def __init__(self, inputs, cell, seconds: float, device, mesh=None):
        from benchmark.harness import port

        if mesh is not None:
            raise ValueError(f"{cell.name}: the train kind runs on one card; "
                             "its configuration may give no mesh")
        self.program = port.Train(inputs, cell.traffic, device)
        self.program.call()
        self.first = {"losses": self.program.losses.clone(),
                      "params": {k: v.detach().clone()
                                 for k, v in self.program.params.items()}}
        self.problem = self.program.problem
        self.call = self.program.call
        self.steps_per_call = self.program.steps_per_call

    def release(self) -> None:
        self.program = self.call = None

    def check(self, inputs, cell, log):
        """(the gaps of the first dispatch and of the program's first
        gradient from the reference's K steps, the reference's live paths
        a launch)."""
        from benchmark.harness import port

        loss, grads = port.gradients(self.problem, inputs.params0,
                                     inputs.frame0)
        self.problem = None
        prog = dict(self.first, grads=grads)
        live = []
        got = check.compare_train(inputs, prog, check.reference_train(
            inputs, cell.traffic, live=live, witness=True))
        first = float(self.first["losses"][0])
        log("train gaps: " + str({k: got[k] for k in (
            "step_loss_gaps", "leaf_change_gaps", "leaf_grad_gaps",
            "leaf_grad_swings", "leaf_grad_norms", "leaves_compared",
            "grad_leaves_compared")})
            + f"; the eager step's loss {float(loss)!r}, the graph's first "
            f"{first!r}")
        counts = {"live_per_launch": sum(live) / inputs.opts["spp"],
                  "texels_per_launch": 0}
        return got, counts


def variants(inputs, traffic: dict) -> dict:
    """{variant: {"loss_gap": gap, "grad_gap": gap}} of the first step:
    the control (the reference in bfloat16 in the program's place) and
    half of the batch left out. A state left unchanged reads 1 on
    ``change_gap`` by construction; a gradient at the wrong scale is
    planted in the program's backward by the card test."""
    ref = check.reference_train(inputs, traffic, steps=1, witness=True)
    h = inputs.opts["height"]
    got = {
        "control": check.reference_train(inputs, traffic, torch.bfloat16,
                                         steps=1),
        "half_batch": check.reference_train(inputs, traffic, rows=h // 2,
                                            steps=1),
    }
    return {k: {n: check.compare_train(inputs, v, ref)[n]
                for n in ("loss_gap", "grad_gap")}
            for k, v in got.items()}


def self_gaps(inputs, traffic: dict) -> dict:
    """The reference against itself over all K steps of a dispatch, once
    in blocks of rows and once in half-size blocks (the same arithmetic,
    summed in another order): the per-step loss gaps and, per leaf, the
    gaps of the change's norms and of the first gradients. What this
    reads, round-off alone gives."""
    rows = check.block_rows(traffic, inputs.opts)
    half = max(1, min(rows, inputs.opts["height"]) // 2)
    a = check.reference_train(inputs, traffic, block=rows)
    b = check.reference_train(inputs, traffic, block=half)
    got = check.compare_train(inputs, a, b)
    return {"loss_gaps": got["step_loss_gaps"],
            "change_gaps": got["leaf_change_gaps"],
            "grad_gaps": got["leaf_grad_gaps"]}


def control(inputs, cell, look: bool = False) -> dict:
    """The control's and the faults' readings, or with ``look`` the
    reference against itself."""
    if look:
        return self_gaps(inputs, cell.traffic)
    return variants(inputs, cell.traffic)
