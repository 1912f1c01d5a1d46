"""The receiver: rebuild a GOP from what crossed the channel (counterpart of
``tvc/pipeline/receiver.py``).

The channel carries (seed, accepts, one container per keyframe coding event).
The receiver decodes the first pair, then replays the sender's updates: each
runs the same prediction on the same decoded history with the same noise
(``update_draws``), and either takes the accepted prefix or decodes the next
container. Both ends run the same kernels with the same launch plans on the
same kind of card, so the frames are the sender's, byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from tvc_torch.core.config import Config
from tvc_torch.models.codec import container
from tvc_torch.pipeline.predictor import FramePredictor
from tvc_torch.pipeline.sender import NoiseSource, stack_frames, update_draws


def run_gop_receiver(cfg: Config, accepts: Sequence[int], containers: List[bytes], coder,
                     predictor: FramePredictor, seed: int, num_frames_total: int = 30,
                     noise: Optional[NoiseSource] = None) -> np.ndarray:
    """(T, H, W, C) decoded frames from the payload: the sender's
    ``GOPResult.accepts`` and ``.containers`` and the seed given to ``run_gop``
    (or the same ``noise`` source)."""
    nc = cfg.data.num_frames_cond
    queue = list(containers)
    acc_queue = list(accepts)

    def decode_next_pair() -> np.ndarray:
        if not queue:
            raise ValueError("the payload holds fewer containers than its accepts need")
        enc = container.deserialize(queue.pop(0), expect_entropy_backend=coder.entropy_backend)
        return coder.decompress(enc["strings"], enc["shape"])["x_hat"]

    frames: List[np.ndarray] = list(decode_next_pair())
    update = 0
    while len(frames) < num_frames_total:
        if not acc_queue:
            raise ValueError("the payload holds fewer accepts than the GOP has updates")
        # the sender ran one prediction here, whether it was accepted or not
        gen, x_init, eps = update_draws(seed, update, predictor.device, noise)
        cond = stack_frames(np.stack(frames[-nc:])[None])
        pred = predictor.generate(cond, generator=gen, x_init=x_init, noise=eps).cpu().numpy()[0]
        n_acc = acc_queue.pop(0)
        update += 1
        if n_acc > 0:
            frames.extend(pred[:n_acc])
        else:
            frames.extend(decode_next_pair())
    if queue or acc_queue:
        raise ValueError(f"{len(queue)} containers and {len(acc_queue)} accepts left unused")
    return np.stack(frames[:num_frames_total])
