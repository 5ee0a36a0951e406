"""The JAX package's MoE routing at its own random initialisation: the
share of tokens each layer's grouped dispatch drops (capacity factor
1.25, 4 experts, 8 layers, batch 4), at widths a CPU runs.

    JAX_PLATFORMS=cpu python tests/moe_routing_reference.py

The port's routing equals the JAX model's on the same weights
(``tests/test_torch_moe.py``); this shows what an untrained router does
in the reference, beside ``chip_smoke.py`` phase 19's dropped share at
the 110M widths on the card.

    JAX_PLATFORMS=cpu python tests/moe_routing_reference.py --tier

runs both packages at the MoE tier's widths (``chip_smoke.py`` phase 19:
vocab 8192, d_model 1024, 8 heads, 8 layers, 4 experts of d_ff 4096,
capacity 1.25, grouped, bf16; dense attention on the CPU) with the batch
and the sequence cut to 1 x 512: the JAX program's seed-0 weights,
carried over by ``models/convert.py``, and both training loops on the
same batches for ``--steps`` AdamW steps. Before each step it prints each
layer's dropped share and expert histogram in each package (the routing
of the forward that step takes), as phase 19 reads the dropped share off
its last step's forward. About 10 GB and some minutes.
"""

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import flax.linen as flax_nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from shockwave_tpu.models.transformer import (  # noqa: E402
    TransformerConfig,
    TransformerLM,
)


def dropped_shares(d_model: int, seq: int, experts: int = 4,
                   capacity_factor: float = 1.25) -> list:
    cfg = TransformerConfig(vocab_size=8192, d_model=d_model,
                            num_heads=max(2, d_model // 128), num_layers=8,
                            d_ff=4 * d_model, max_len=seq,
                            num_experts=experts,
                            moe_capacity_factor=capacity_factor)
    model = TransformerLM(cfg)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, 8192, (4, seq)),
                         jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), tokens)
    _, inter = model.apply(variables, tokens, capture_intermediates=True,
                           mutable=["intermediates"])
    params = flax_nn.meta.unbox(variables)["params"]
    shares = []
    for i in range(cfg.num_layers):
        x = inter["intermediates"][f"block_{i}"]["ln2"]["__call__"][0]
        gates = x @ params[f"block_{i}"]["moe"]["router"]["kernel"]
        top = np.asarray(jnp.argmax(jax.nn.softmax(gates, -1), -1)).ravel()
        n = top.size
        capacity = min(-(-math.ceil(capacity_factor * n / experts) // 8) * 8,
                       n)
        counts = np.bincount(top, minlength=experts)
        shares.append(float(np.maximum(counts - capacity, 0).sum() / n))
    return shares


def _routing(tops, experts: int, capacity_factor: float) -> list:
    """Each layer's (dropped share, expert histogram) of its top-1 picks,
    under the grouped dispatch's capacity."""
    out = []
    for top in tops:
        n = top.size
        capacity = min(-(-math.ceil(capacity_factor * n / experts) // 8) * 8,
                       n)
        counts = np.bincount(top, minlength=experts)
        out.append((float(np.maximum(counts - capacity, 0).sum() / n),
                    counts.tolist()))
    return out


def tier_routing(steps: int = 5, batch: int = 1, seq: int = 512) -> dict:
    """Both packages' routing at the MoE tier's widths, before each of
    ``steps`` training steps, from the same weights and batches."""
    import torch
    import torch.nn.functional as F

    from shockwave_tpu.models.train import build_family as jax_build_family
    from shockwave_tpu_torch.models import train
    from shockwave_tpu_torch.models.convert import family_params_from_jax

    flags = ["--model", "Transformer", "--batch_size", str(batch),
             "--seq_len", str(seq), "--vocab_size", "8192", "--d_model",
             "1024", "--num_heads", "8", "--num_layers", "8", "--dtype",
             "bfloat16", "--attention", "dense", "--num_experts", "4",
             "--moe_dispatch", "grouped", "--moe_capacity_factor", "1.25",
             "-n", str(steps), "--device", "cpu"]
    args = train.parse_args(flags)
    experts, cf = args.num_experts, args.moe_capacity_factor
    variables, jax_step, opt_state, jax_batch = jax_build_family(
        "Transformer", args, mesh=None)
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers,
        d_ff=4 * args.d_model, max_len=args.seq_len, dtype=args.dtype,
        attention=args.attention, num_experts=experts,
        moe_capacity_factor=cf, moe_dispatch=args.moe_dispatch)
    jax_model = TransformerLM(cfg)
    init = jax.tree.map(np.asarray, flax_nn.meta.unbox(variables))

    @jax.jit
    def jax_tops(variables, tokens):
        _, inter = jax_model.apply(variables, tokens,
                                   capture_intermediates=True,
                                   mutable=["intermediates"])
        params = flax_nn.meta.unbox(variables)["params"]
        tops = []
        for i in range(cfg.num_layers):
            x = inter["intermediates"][f"block_{i}"]["ln2"]["__call__"][0]
            gates = x.astype(jnp.float32) @ params[f"block_{i}"]["moe"][
                "router"]["kernel"]
            tops.append(jnp.argmax(jax.nn.softmax(gates, -1), -1).ravel())
        return tops

    step = jax.jit(jax_step)
    rng = np.random.default_rng(args.seed)
    batches = [jax_batch(rng) for _ in range(steps)]
    jax_runs, jax_losses = [], []
    for b in batches:
        jax_runs.append(_routing([np.asarray(t) for t in
                                  jax_tops(variables, b[:, :-1])],
                                 experts, cf))
        variables, opt_state, loss = step(variables, opt_state, b)
        jax_losses.append(float(loss))
    del variables, opt_state, step

    model, step_fn, _, _ = train.build_family("Transformer", args,
                                              torch.device("cpu"))
    model.load_state_dict(family_params_from_jax("Transformer", init))
    del init
    tops = []

    def record(moe, inputs):
        x = inputs[0]
        weights = torch.softmax(F.linear(x.float(), moe.router.weight), -1)
        tops.append(torch.argmax(weights, -1).reshape(-1).numpy())

    for block in model.blocks:
        block.moe.register_forward_pre_hook(record)
    port_runs, port_losses = [], []
    for b in batches:
        tops.clear()
        port_losses.append(float(step_fn(torch.from_numpy(np.asarray(b)))))
        port_runs.append(_routing(tops, experts, cf))
    return {"jax": jax_runs, "port": port_runs, "jax_losses": jax_losses,
            "port_losses": port_losses}


def print_tier(steps: int) -> None:
    runs = tier_routing(steps)
    for k in range(steps):
        for pkg in ("jax", "port"):
            layers = runs[pkg][k]
            print(f"step {k} {pkg:4s}: dropped "
                  f"{[round(d, 3) for d, _ in layers]} (mean "
                  f"{sum(d for d, _ in layers) / len(layers):.3f}); experts "
                  f"{[h for _, h in layers]}", flush=True)
    print(f"losses jax {runs['jax_losses']}\n       port "
          f"{runs['port_losses']}")


if __name__ == "__main__":
    if "--tier" in sys.argv:
        steps = (int(sys.argv[sys.argv.index("--steps") + 1])
                 if "--steps" in sys.argv else 5)
        print_tier(steps)
        sys.exit(0)
    for d_model, seq in ((256, 256), (512, 512)):
        shares = dropped_shares(d_model, seq)
        print(f"d_model {d_model}, seq {seq}: dropped share by layer "
              f"{[round(s, 3) for s in shares]}, mean "
              f"{sum(shares) / len(shares):.3f}")
