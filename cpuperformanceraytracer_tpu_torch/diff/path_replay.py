"""Path-replay backward: gradients through the oracle's bounce loop with
each segment recomputed in the backward sweep.

Counterpart of ``cpuperformanceraytracer_tpu.diff.path_replay``. Plain
reverse mode through the bounce loop keeps every intermediate of every
segment until the backward sweep: memory grows with the bounce count.
Path replay keeps each segment's input carry and replays the segment
when the sweep reaches it. The counter RNG addresses its draws by
(pixel, frame, sample, draw index), so the replay takes the same lottery
decisions and directions; ``torch.utils.checkpoint`` on the bounce body
is exactly that (``RenderConfig.remat_bounces``, read by
``render/integrator.color_for_ray``).
"""

from __future__ import annotations

from typing import Dict

import torch

from cpuperformanceraytracer_tpu_torch.diff.grad import apply_params
from cpuperformanceraytracer_tpu_torch.render.integrator import render_frame


def render_for_params_replay(params: Dict, scene, camera, texture, cfg,
                             frame=0) -> torch.Tensor:
    """``diff.grad.render_for_params`` through the oracle with replayed
    bounces: (3, H, W). The counter RNG is the contract for an exact
    replay (the wang state replays too, as it rides in the carry)."""
    scene, texture = apply_params(scene, texture, params)
    return render_frame(scene, camera, texture,
                        cfg.replace(remat_bounces=True).validate(), frame)
