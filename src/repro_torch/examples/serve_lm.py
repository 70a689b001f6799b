"""Batched serving example, the twin of ``examples/serve_lm.py``: prefill
and greedy decode on the card at a reduced config.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
      --arch mamba2-1.3b --gen 32

``--device cpu`` runs the plain path.
"""
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    return serve_main(argv)


if __name__ == "__main__":
    main()
