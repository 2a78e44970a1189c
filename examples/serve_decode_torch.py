"""Serve a small model with batched requests on the PyTorch port:
KV-cache greedy decode for a batch of prompts (the reference's
``examples/serve_decode.py``, same sizes and lines), on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]

Init and prompts come from seeded ``torch.Generator``s, so the sampled
tokens are not the reference's.
"""
import argparse
import time

import torch

from repro_torch.configs import get_spec
from repro_torch.models import Transformer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    cfg = get_spec("mixtral-8x7b").smoke_config  # SWA + MoE smoke config
    model = Transformer(cfg, seed=0, device=dev)
    b, prompt_len, gen = 8, 6, 24
    cache = model.init_cache(b, prompt_len + gen)
    prompts = torch.randint(0, cfg.vocab, (b, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    prompts = prompts.to(dev)
    tok = prompts[:, 0]
    outs = []
    t0 = time.time()
    for pos in range(prompt_len + gen - 1):
        logits, cache = model.decode_step(cache, tok, pos)
        tok = (prompts[:, pos + 1] if pos + 1 < prompt_len
               else torch.argmax(logits, dim=-1))
        if pos + 1 >= prompt_len:
            outs.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    gen_toks = torch.stack(outs, 1)
    print(f"served batch={b}: {b*len(outs)} tokens in {dt:.2f}s "
          f"({b*len(outs)/dt:.1f} tok/s, rolling SWA cache "
          f"len={cache['k'].shape[2]})")
    print("sample:", prompts[0].tolist(), "->", gen_toks[0].tolist())


if __name__ == "__main__":
    main()
