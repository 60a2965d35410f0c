"""How far greedy decode's logits drift from ``forward``'s in the SSM
family at full width: random weights, `batch` 64-token prompts, prefill and
`new` - 1 decode steps, then one ``forward`` over the prompt and the
generated tokens; prints each position's largest |decode - forward| over
max(1, max |forward's logits|). With ``--ref`` the weights are the
reference's (``repro``, JAX) init carried into the port, and the
reference decodes the port's tokens (teacher-forced) and runs ``forward``
on them too: both packages' drift on the same weights and tokens, and how
far the two ``forward``s are apart.

    PYTHONPATH=src python examples/torch_ssm_drift.py --layers 16
        [--arch mamba2-2.7b] [--dtype bfloat16] [--new 4] [--batch 2]
        [--ref]

Runs on the CPU; keep the depth small there (16 layers of Mamba2 are
1.4 GB in bf16). ``chip_smoke.py`` phase 17 holds the decode path to
``forward`` in fp32 at full depth and in bf16 at a cut depth, and prints
the full depth's bf16 drift.
"""
import argparse
import dataclasses

import numpy as np


def _by_position(dec, full):
    """Per position: max |dec - full| / max(1, max |full|), over the
    batch and the vocab (numpy, (B, new, V))."""
    return [float(np.abs(dec[:, i] - full[:, i]).max())
            / max(1.0, float(np.abs(full[:, i]).max()))
            for i in range(dec.shape[1])]


def _reference(arch, layers, dtype):
    """The reference's model and init at `layers`, and its params in the
    port's layout."""
    import jax
    from repro.configs import get_config
    from repro.models.transformer import LanguageModel
    from repro_torch.convert import params_from_jax
    cfg = dataclasses.replace(get_config(arch).model, n_layers=layers,
                              dtype=dtype)
    model = LanguageModel(cfg, head_tp=False, chunk_k=1024)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    return model, params, params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _reference_logits(model, params, tokens, new):
    """The reference's decode logits on `tokens` (B, 64 + new - 1),
    teacher-forced, and its forward logits at the same positions."""
    import jax
    import jax.numpy as jnp
    prefill = jax.jit(lambda p, t, c: model.prefill(p, {"tokens": t}, c))
    decode = jax.jit(lambda p, t, c: model.decode_step(p, {"tokens": t}, c))
    B = tokens.shape[0]
    logits, caches = prefill(params, jnp.asarray(tokens[:, :64]),
                             model.init_cache(B, 64 + new))
    outs = [logits[:, -1]]
    for i in range(new - 1):
        logits, caches = decode(params, jnp.asarray(tokens[:, 64 + i:65 + i]),
                                caches)
        outs.append(logits[:, -1])
    full, _ = jax.jit(lambda p, t: model.forward(p, {"tokens": t}))(
        params, jnp.asarray(tokens))
    return (np.asarray(jnp.stack(outs, 1), np.float32),
            np.asarray(full[:, 63:], np.float32))


def drift(arch, layers, dtype, new, batch, ref):
    """{row name: per-position drift}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LanguageModel
    cfg = dataclasses.replace(get_config(arch).model, n_layers=layers,
                              dtype=dtype)
    model = LanguageModel(cfg, device="cpu")
    if ref:
        j_model, j_params, params = _reference(arch, layers, dtype)
    else:
        params = model.init(torch.Generator().manual_seed(17))
    prompts = torch.randint(1, cfg.vocab_size, (batch, 64),
                            generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": prompts},
                                       model.init_cache(batch, 64 + new))
        outs, toks = [logits[:, -1]], [logits[:, -1].argmax(-1)]
        for _ in range(new - 1):
            logits, caches = model.decode_step(
                params, {"tokens": toks[-1][:, None]}, caches)
            outs.append(logits[:, -1])
            toks.append(logits[:, -1].argmax(-1))
        tokens = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
        full, _ = model.forward(params, {"tokens": tokens})
    V = cfg.vocab_size
    dec = torch.stack(outs, 1)[..., :V].float().numpy()
    full = full[:, 63:, :V].float().numpy()
    rows = {"port decode vs port forward": _by_position(dec, full)}
    if ref:
        j_dec, j_full = _reference_logits(j_model, j_params,
                                          tokens.numpy().astype(np.int32),
                                          new)
        rows["reference decode vs reference forward"] = _by_position(
            j_dec[..., :V], j_full[..., :V])
        rows["port forward vs reference forward"] = _by_position(
            full, j_full[..., :V])
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--new", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ref", action="store_true")
    args = ap.parse_args(argv)
    what = (f"{args.arch} {args.layers} layers {args.dtype} batch "
            f"{args.batch}")
    for name, per in drift(args.arch, args.layers, args.dtype, args.new,
                           args.batch, args.ref).items():
        print(f"{what}: {name} by position {per}; worst {max(per)}")


if __name__ == "__main__":
    main()
