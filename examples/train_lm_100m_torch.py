"""End to end on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps with checkpointing and auto-resume
(``examples/train_lm_100m.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/train_lm_100m_torch.py --device cpu
    PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 300  # card
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")
from repro_torch.launch import train as train_mod  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
ap.add_argument("--device", default="cuda",
                help="torch device of the model, optimizer and data")
args = ap.parse_args()

# internlm2 family scaled to ~100M params: the launcher's --scale knob
# multiplies width on the reduced config; scale 12 -> d_model 768 d_ff 1536.
params, final_loss = train_mod.run([
    "--arch", "internlm2-1.8b", "--smoke", "--scale", "12",
    "--steps", str(args.steps), "--batch", "4", "--seq", "256",
    "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
    "--log-every", "10", "--device", args.device,
])
print(f"final loss: {final_loss:.4f} (checkpoints in {args.ckpt_dir})")
