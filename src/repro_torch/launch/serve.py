"""Serving launcher: batched greedy decode with a KV cache for an LM arch
(port of ``repro.launch.serve``, on the card unless ``--device cpu``).
Every flag is the reference's, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --smoke --batch 4 --prompt-len 8 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch deepseek-7b --smoke

The prompt is prefilled by decode steps, one position a step, as the
reference's driver does; then each step feeds back the argmax. It prints
the reference's three kinds of line: the run's shape, the throughput
(generated tokens over the wall time of every step, prefill included;
the line names the card, or "host CPU") and two sample sequences.
Prompts are drawn from a seeded ``torch.Generator``, so their tokens are
not the reference's.
"""
from __future__ import annotations

import argparse
import time
from contextlib import nullcontext

import torch


def load(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
         device="cuda"):
    """(model, cache, prompts (B, prompt_len) on the model's device) for a
    decode of ``gen`` tokens after the prompt."""
    from ..models.transformer import Transformer
    model = Transformer(cfg, seed=seed, device=device)
    dev = model.embed.device
    g = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g)
    return model, model.init_cache(batch, prompt_len + gen), prompts.to(dev)


def generate(model, cache, prompts, gen: int, span=None):
    """Prefill by decode steps, then greedy decode; returns the generated
    tokens (B, gen). ``span``, a ``StepTimer.span``-like context factory,
    wraps each step."""
    prompt_len = prompts.shape[1]
    span = span or (lambda _kind: nullcontext())
    tok = prompts[:, 0]
    generated = []
    for pos in range(prompt_len + gen - 1):
        with span("step"):
            logits, cache = model.decode_step(cache, tok, pos)
        if pos + 1 < prompt_len:
            tok = prompts[:, pos + 1]
        else:
            tok = torch.argmax(logits, dim=-1)
            generated.append(tok)
    return torch.stack(generated, dim=1)


def device_label(dev) -> str:
    dev = torch.device(dev)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, the card) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_spec
    from ..runtime import resolve_device

    try:
        spec = get_spec(args.arch)
    except KeyError as e:
        raise SystemExit(f"launch.serve: {e.args[0]}")
    if spec.family != "lm":
        raise SystemExit("decode serving applies to LM archs")
    dev = resolve_device(args.device)
    cfg = spec.smoke_config if args.smoke else spec.config
    b = args.batch
    model, cache, prompts = load(cfg, b, args.prompt_len, args.gen,
                                 device=dev)
    t0 = time.time()
    gen = generate(model, cache, prompts, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={b} prompt={args.prompt_len} "
          f"gen={gen.shape[1]} tokens")
    print(f"throughput: {b * gen.shape[1] / dt:.1f} tok/s "
          f"({device_label(dev)})")
    for i in range(min(b, 2)):
        print(f"  seq{i}: {prompts[i].tolist()} -> {gen[i].tolist()}")


if __name__ == "__main__":
    main()
