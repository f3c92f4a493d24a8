"""Serve one saved FixedKAN model through the int8 recipes of both
packages on the CPU, and split the error by operand:

    python tools/int8_recipes_vs_jax.py MODEL.npz [--out PATH.json]

For the digits-784 test set (360 digits) it prints, for 'int8x2',
'int8x2w' and 'int8': the test accuracy of the JAX package's recipe and
of the port's (the same npz loads in both), max|logit - the float64
fold| for each, and the gap between the two packages' logits (their
float32 tanh can differ by an ulp, which moves a rounding across a
half).  Then the JAX package's own decomposition of one-level int8
(``benchmarks/eval_precision_probe.py``): the basis alone rounded to
1/127 steps, and the weights alone to their per-column 1/127 steps, in
float64 products.  Runs on the CPU only (it imports the JAX package);
``chip_smoke.py`` phase 15c writes such a model on the card.
"""

from __future__ import annotations

import argparse
import json
import warnings

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from qkan_implementation_tpu.models.fixed_kan import (
        FixedKAN as JaxKAN,
        kan_apply as jax_apply,
    )
    from qkan_implementation_tpu.ops.chebyshev import chebyshev_basis
    from qkan_implementation_tpu_torch.data import load_digits_784
    from qkan_implementation_tpu_torch.models.fixed_kan import (
        FixedKAN as PortKAN,
        kan_apply as port_apply,
    )

    x, labels, _ = load_digits_784(train=False)
    jm = JaxKAN.load_model(args.model)
    pm = PortKAN.load_model(args.model, device="cpu")
    d = jm.config.max_degree
    ref = np.asarray(jax_apply(jm.params, jnp.asarray(x, dtype=jnp.float64),
                               d, matmul_precision="highest"))

    def accuracy(logits):
        return float((logits.argmax(axis=1) == labels).mean())

    out = {"model": args.model, "float64_accuracy": accuracy(ref),
           "logit_std": float(ref.std())}
    jp32 = [{k: jnp.asarray(np.asarray(v)) for k, v in lp.items()}
            for lp in jm.params]
    warnings.simplefilter("ignore")  # 'int8' warns at this fan-in
    for recipe in ("int8x2", "int8x2w", "int8"):
        jo = np.asarray(jax_apply(
            jp32, jnp.asarray(x, dtype=jnp.float32), d,
            compute_dtype=jnp.int8 if recipe == "int8" else recipe))
        po = port_apply(pm.params, torch.as_tensor(x, dtype=torch.float32),
                        d, compute_dtype=recipe).numpy()
        out[recipe] = {
            "jax_accuracy": accuracy(jo), "port_accuracy": accuracy(po),
            "jax_err_vs_f64": float(np.abs(jo - ref).max()),
            "port_err_vs_f64": float(np.abs(po - ref).max()),
            "port_vs_jax": float(np.abs(po - jo).max()),
        }

    def one_sided(round_basis: bool) -> np.ndarray:
        cur = jnp.asarray(x, dtype=jnp.float64)
        for lp in jm.params:
            basis = chebyshev_basis(jnp.tanh(cur), d, clip=False)
            mask = jnp.arange(d + 1)[None, :] <= lp["degrees"][:, None]
            W = jnp.einsum(
                "oidt,od->idt", lp["coefficients"],
                mask.astype(lp["coefficients"].dtype)
                * lp["horizontal_weights"][:, None],
            ).reshape(-1, lp["coefficients"].shape[-1])
            a = basis.reshape(x.shape[0], -1)
            if round_basis:
                a = jnp.round(a * 127.0) / 127.0
            else:
                s = jnp.max(jnp.abs(W), axis=0, keepdims=True)
                W = jnp.round(W / s * 127.0) / 127.0 * s
            cur = a @ W
        return np.asarray(cur)

    for name, flag in (("basis_only", True), ("weights_only", False)):
        o = one_sided(flag)
        out[name] = {"jax_accuracy": accuracy(o),
                     "err_vs_f64": float(np.abs(o - ref).max())}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
