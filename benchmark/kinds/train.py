"""The ``train`` traffic kind: inverse-rendering jobs with Adam, one
dispatch of ``make_train_step_k``'s K steps a call.

Its own inputs are the trained parameters' start, off the truth by the
seed, the frame the target is rendered at and the first step's frame.
The set-up's first dispatch, the window's own call on the same state,
captures the graph and is the one judged: the reference renders the
target and follows its K steps with autograd and Adam
(``check.reference_train``), and ``check.compare_train`` compares the
first step's loss and each parameter leaf's change.
"""

from __future__ import annotations

import torch

from benchmark.harness import check, window


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
    """{work file: launches a dispatch}: A, C and D once a sample of each
    of the K steps, B once a step."""
    k = traffic["steps_per_dispatch"]
    return {"kernel_a": k * opts["spp"], "kernel_b": k,
            "kernel_c": k * opts["spp"], "kernel_d": k * opts["spp"]}


class Session(window.Session):
    """The program's training loop with its first dispatch run (which
    captures the graph) and its losses and parameters kept."""

    def __init__(self, inputs, cell, seconds: float, device):
        from benchmark.harness import port

        self.program = port.Train(inputs, cell.traffic, device)
        self.program.call()
        self.first = {"losses": self.program.losses.clone(),
                      "params": {k: v.detach().clone()
                                 for k, v in self.program.params.items()}}
        self.call = self.program.call
        self.steps_per_call = self.program.steps_per_call

    def release(self) -> None:
        self.program = self.call = None

    def check(self, inputs, cell, log):
        """(the gaps of the first dispatch from the reference's K steps,
        the reference's live paths a launch)."""
        live = []
        got = check.compare_train(inputs, self.first, check.reference_train(
            inputs, cell.traffic, live=live))
        log("train gaps: " + str({k: got[k] for k in (
            "step_loss_gaps", "leaf_change_gaps", "leaf_grad_norms",
            "leaves_compared")}))
        counts = {"live_per_launch": float(sum(live)), "texels_per_launch": 0}
        return got, counts


def variants(inputs, traffic: dict) -> dict:
    """{variant: {"loss_gap": gap}} of the first step's loss: the control
    (the reference in bfloat16 in the program's place) and half of the
    batch left out. A state left unchanged reads 1 on ``change_gap`` by
    construction."""
    ref = check.reference_train(inputs, traffic, steps=1)
    h = inputs.opts["height"]
    got = {
        "control": check.reference_train(inputs, traffic, torch.bfloat16,
                                         steps=1),
        "half_batch": check.reference_train(inputs, traffic, rows=h // 2,
                                            steps=1),
    }
    return {k: {"loss_gap": check.compare_train(inputs, v, ref)["loss_gap"]}
            for k, v in got.items()}


def self_gaps(inputs, traffic: dict) -> dict:
    """The reference against itself over all K steps of a dispatch, once
    in blocks of rows and once in half-size blocks (the same arithmetic,
    summed in another order): the per-step loss gaps and, per leaf, the
    gaps of the change's norms. What this reads, round-off alone gives."""
    rows = check.block_rows(traffic, inputs.opts)
    half = max(1, min(rows, inputs.opts["height"]) // 2)
    a = check.reference_train(inputs, traffic, block=rows)
    b = check.reference_train(inputs, traffic, block=half)
    got = check.compare_train(inputs, a, b)
    return {"loss_gaps": got["step_loss_gaps"],
            "change_gaps": got["leaf_change_gaps"]}


def control(inputs, cell, look: bool = False) -> dict:
    """The control's and the faults' readings, or with ``look`` the
    reference against itself."""
    if look:
        return self_gaps(inputs, cell.traffic)
    return variants(inputs, cell.traffic)
