"""Train an LM with the port's production launcher (checkpointed,
resumable, watchdogged): the reduced config. The twin of
`examples/train_lm.py`; under `torchrun` with `--mesh local` the ranks
split the model axis.

    PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2_780m \
        --steps 50
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a == "--arch" or a.startswith("--arch=") for a in argv):
        argv += ["--arch", "mamba2_780m", "--steps", "50"]
    if "--reduced" not in argv:
        argv.append("--reduced")
    main(argv)
