"""The port's profilers of the B=1 rollout and of the train step
(counterparts of `scripts/fused_b1_profile.py`, `loss_profile.py`,
`grad_profile.py`, `train_step_profile.py` and `train_roofline.py`); each
runs as ``python -m zeggs_tpu_torch.profilers.<name>``."""
