"""End-to-end LM training driver, the twin of ``examples/train_lm.py``:
trains a reduced config on the card with checkpoints and resume.

  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
      --arch stablelm-1.6b --steps 200

Any of the 10 architectures works (``--arch mamba2-1.3b``, ``--arch
qwen3-moe-235b-a22b``, ``--arch whisper-base``, …), at its reduced config.
Checkpoints go under the temporary directory unless ``--checkpoint-dir``
says where; ``--device cpu`` runs the plain path.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    if "--steps" not in argv:
        argv += ["--steps", "200"]
    if "--checkpoint-dir" not in argv:
        argv += ["--checkpoint-dir",
                 os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")]
    return train_main(argv)


if __name__ == "__main__":
    main()
