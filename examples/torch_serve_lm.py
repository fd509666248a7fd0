"""Serve a small LM with batched requests (continuous-batching loop) on
the PyTorch/CUDA port. The twin of `examples/serve_lm.py`.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2_5_3b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a == "--arch" or a.startswith("--arch=") for a in argv):
        argv += ["--arch", "qwen2_5_3b"]
    if "--reduced" not in argv:
        argv.append("--reduced")
    main(argv)
