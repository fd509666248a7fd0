"""End-to-end script (§6 pipeline) on the PyTorch/CUDA port: QAT-train an
MLP classifier with torch autograd, quantize to int16, convert to a
HiAER-Spike network (A.2), run inference on the event-driven HBM engine,
and report accuracy + energy/latency — the Table 2 protocol on the
synthetic stand-in dataset. The twin of `examples/train_and_deploy_snn.py`.

    PYTHONPATH=src python examples/torch_train_and_deploy_snn.py        # card
    PYTHONPATH=src python examples/torch_train_and_deploy_snn.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.convert import (LayerSpec, QATModel, apply_quantized,
                                      infer_image, quantize, to_network,
                                      train_qat)
from repro_torch.data.synthetic import digits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--n-train", type=int, default=1500)
    ap.add_argument("--n-test", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where training and the engine run (default: the "
                         "card; cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    print("== 1. synthetic binarized digits (28x28, MNIST-shaped) ==")
    X, y = digits(args.n_train + args.n_test, shape=(28, 28), seed=0)
    Xf = X.reshape(-1, 1, 28, 28).astype(np.float32)
    Xtr, ytr = Xf[:args.n_train], y[:args.n_train]
    Xte, yte = X[args.n_train:], y[args.n_train:]

    print(f"== 2. QAT training (binary activations, surrogate gradient) "
          f"on {args.device} ==")
    model = QATModel(input_shape=(1, 28, 28),
                     layers=[LayerSpec("dense", out_features=args.hidden)],
                     n_classes=10)
    params = train_qat(model, Xtr, ytr, epochs=args.epochs, verbose=True,
                       device=args.device)

    print("== 3. int16 quantization ==")
    qp, bits = quantize(params)
    ref = apply_quantized(model, qp, Xf[args.n_train:].astype(np.int64))
    sw_acc = float((ref.argmax(1) == yte).mean())
    print(f"   scale 2^{bits}; software (quantized) acc = {sw_acc:.4f}")

    print("== 4. convert to HiAER-Spike (A.2) & deploy on the engine ==")
    net, out_keys = to_network(model, qp, backend="engine",
                               device=args.device)
    stats = net.image.stats()
    print(f"   HBM: {stats['hbm_rows']} rows, packing density "
          f"{stats['packing_density']:.3f}")

    correct = 0
    net.counter.reset()
    mismatch = 0
    for i in range(args.n_test):
        pred, pots = infer_image(net, Xte[i], model, out_keys)
        correct += pred == yte[i]
        mismatch += not np.array_equal(np.asarray(pots), ref[i])
    hw_acc = correct / args.n_test
    c = net.counter.as_dict()
    print(f"   HiAER acc = {hw_acc:.4f} (software {sw_acc:.4f}, "
          f"potential mismatches: {mismatch})")
    print(f"   per-inference: energy = "
          f"{c['energy_uJ'] / args.n_test:.2f} uJ, latency = "
          f"{c['latency_us'] / args.n_test:.2f} us "
          f"({c['total_accesses'] / args.n_test:.0f} HBM accesses)")
    if mismatch:
        raise SystemExit("conversion must be bit-exact")


if __name__ == "__main__":
    main()
