"""Train a small LM with the full training substrate (AdamW, schedule,
checkpointable state) on the synthetic token stream, on the PyTorch port
(the reference's ``examples/train_lm.py``, same model and batches' shape
and lines), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]

Init and batches come from seeded ``torch.Generator``s, so the losses are
not the reference's bits.
"""
import argparse
import time

import torch

from repro_torch.models import Transformer, TransformerConfig
from repro_torch.train import (AdamWConfig, DataConfig, init_opt_state,
                               lm_batch, make_train_step, to_device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    cfg = TransformerConfig(
        name="demo-20m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        d_head=32, d_ff=1024, vocab=8192, remat=False)
    model = Transformer(cfg, seed=0, device=dev)
    n = sum(p.numel() for p in model.parameters())
    print(f"model: {n/1e6:.1f}M params ({cfg.name})")
    oc = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(lambda m, b: m.loss(b), oc)
    st = init_opt_state(model)
    dc = DataConfig(kind="lm", global_batch=8, seq_len=64, vocab=cfg.vocab)
    t0 = time.time()
    for s in range(args.steps):
        _, st, m = step(model, st, to_device(lm_batch(dc, s), dev))
        if s % 20 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {float(m['loss']):.4f} "
                  f"({(s+1)/(time.time()-t0):.2f} steps/s)", flush=True)


if __name__ == "__main__":
    main()
