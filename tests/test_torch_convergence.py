"""Learning check of the port (a port of tests/test_convergence.py): the
whole train step learns on the CPU.

On the synthetic blob dataset (keypoints are rendered into the image, the
same samples as the JAX package's), a tiny float32 ViT must lift keypoint
PCK and in-image probability accuracy above their starting levels within
150 steps, by the margins the JAX test requires.
"""

import numpy as np
import torch

from probpose_pytorch_tpu_torch.data import SyntheticPoseDataset, batch_iterator
from probpose_pytorch_tpu_torch.models.model import ModelConfig
from probpose_pytorch_tpu_torch.models.vit import ViTConfig
from probpose_pytorch_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)  # the suite runs in several workers beside timing tests

ViTConfig.PRESETS.setdefault("vit-conv-test", dict(embed_dim=64, depth=2, num_heads=2,
                                                   mlp_ratio=2.0))


def test_training_learns_keypoints(tmp_path):
    cfg = TrainConfig(
        model=ModelConfig(img_size=(64, 48), num_keypoints=5, backbone="vit-conv-test",
                          compute_dtype="float32", deconv_out_channels=(32, 32),
                          deconv_kernel_sizes=(4, 4), pool_sizes=((2, 2), (2, 2)),
                          normalize=1.0),
        train_batch_size=16,
        out_dir=str(tmp_path),
    )
    trainer = Trainer.create(cfg, steps_per_epoch=150, device="cpu")
    ds = SyntheticPoseDataset(64, cfg.model.img_size, 5, seed=1)
    batch0 = trainer.device_batch(next(iter(batch_iterator(ds, 16, num_workers=1))))
    m0 = trainer.eval_step(trainer.state, batch0)

    step = 0
    for epoch in range(100):
        for batch in batch_iterator(ds, 16, shuffle=True, seed=0, epoch=epoch, num_workers=2):
            trainer.train_step(trainer.state, trainer.device_batch(batch))
            step += 1
            if step >= 150:
                break
        if step >= 150:
            break

    m1 = trainer.eval_step(trainer.state, batch0)
    pck0, pck1 = float(m0["acc/kpt"]), float(m1["acc/kpt"])
    prob0, prob1 = float(m0["acc/probability"]), float(m1["acc/probability"])
    print(f"PCK {pck0:.4f} -> {pck1:.4f}, probability accuracy {prob0:.4f} -> {prob1:.4f}")
    assert np.isfinite([pck1, prob1]).all()
    assert pck1 > max(0.2, pck0 + 0.15), (pck0, pck1)
    assert prob1 > max(0.7, prob0), (prob0, prob1)
