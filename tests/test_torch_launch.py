"""The port's launchers on the CPU. ``python -m
repro_torch.launch.serve_rank``: the same synthetic graph and seed
through it and through the JAX package's launcher give the same cache,
plan and spill counters and the same top-k; the queued frontend answers
``/healthz``, rolls a ``--delta-file`` on SIGHUP and drains to exit 0 on
SIGTERM; and its helpers (``zipf_query_stream``, ``load_delta_file``,
``roll_delta``) match the reference's. ``python -m
repro_torch.launch.train``: each recsys ``--arch --smoke`` and an LM
one, ``--ckpt``/``--resume``, checkpoints that cross packages both ways
(recsys and LM), and the refusals. ``python -m
repro_torch.launch.serve``: each LM ``--arch --smoke`` prints the
reference's three kinds of line, and a non-LM arch is refused as the
reference refuses it.

Every wait on the subprocess has a timeout, so a hang fails the test.
"""
import ast
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graph import WebGraphSpec as RefSpec
from repro.graph import generate_webgraph as ref_generate
from repro.launch import serve_rank as rlaunch
from repro.serve import RankService as RefService
from repro.serve import RankServiceConfig as RefConfig
from repro_torch.graph import WebGraphSpec, from_reference, generate_webgraph
from repro_torch.launch import serve_rank as plaunch
from repro_torch.serve import RankService, RankServiceConfig

ROOT = Path(__file__).resolve().parents[1]
WAIT = 180  # seconds any subprocess step may take before the test fails
GRAPH = ["--dataset", "synthetic", "--n-nodes", "3000", "--n-edges", "24000",
         "--seed", "0"]


def env():
    # one intra-op thread: the suite's other workers share the host
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def launch(module, *args, cwd):
    r = subprocess.run([sys.executable, "-m", module, *args],
                       capture_output=True, text=True, env=env(), cwd=cwd,
                       timeout=WAIT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    return r.stdout


def line(out, prefix):
    hits = [x for x in out.splitlines() if x.startswith(prefix)]
    assert hits, (prefix, out)
    return hits[-1]


def topk(out):
    """The sample query's root set and top-k (node, score) pairs."""
    m = re.search(r"sample query (\[.*?\]) \[(\w+).*?top-\d+ authorities "
                  r"(\[.*\])", out)
    assert m, out
    return ast.literal_eval(m.group(1)), m.group(2), \
        ast.literal_eval(m.group(3))


def test_launcher_matches_reference(tmp_path):
    """Both launchers (sync frontend) on the same graph, stream and spill
    layout: equal hit/warm/cold and plan counters, equal spill writes, the
    same sample top-k (nodes equal, scores within 1e-9); then a relaunch
    of each on its spill dir restores as many entries and serves the
    stream as hits. (The queued frontend's batches depend on arrival
    timing, so its counters are not compared across two processes.)"""
    args = GRAPH + ["--requests", "40", "--v", "4", "--backend", "dense"]
    outs = {}
    for name, module in (("ref", "repro.launch.serve_rank"),
                         ("port", "repro_torch.launch.serve_rank")):
        spill = str(tmp_path / name)
        extra = ["--device", "cpu"] if name == "port" else []
        first = launch(module, *args, *extra, "--spill-dir", spill,
                       cwd=tmp_path)
        again = launch(module, *args, *extra, "--spill-dir", spill,
                       cwd=tmp_path)
        outs[name] = (first, again)
    for i in range(2):
        r, p = outs["ref"][i], outs["port"][i]
        for prefix in ("graph:", "cache:", "plans:", "iterated queries:"):
            if i == 1 and prefix == "iterated queries:":
                continue  # a relaunch serves hits only: nothing iterated
            assert line(p, prefix) == line(r, prefix), prefix
        assert line(p, "spill:").split(" -> ")[0] == \
            line(r, "spill:").split(" -> ")[0]
        rr, rs, rk = topk(r)
        pr, ps, pk = topk(p)
        assert (pr, ps) == (rr, rs)
        assert [n for n, _ in pk] == [n for n, _ in rk]
        assert max(abs(a - b) for (_, a), (_, b) in zip(pk, rk)) <= 1e-9
    again = outs["port"][1]
    assert line(again, "spill: restored").split(" from ")[0] == \
        line(outs["ref"][1], "spill: restored").split(" from ")[0]
    assert "(100.0% hit rate)" in line(again, "cache:")


class Lines:
    """A subprocess's stdout read by a thread, waited on with timeouts."""

    def __init__(self, proc):
        self.q, self.seen = queue.Queue(), []
        threading.Thread(target=self._pump, args=(proc.stdout,),
                         daemon=True).start()

    def _pump(self, f):
        for x in f:
            self.q.put(x.rstrip("\n"))
        self.q.put(None)

    def wait_for(self, prefix, timeout=WAIT):
        end = time.monotonic() + timeout
        while True:
            left = end - time.monotonic()
            assert left > 0, (prefix, self.seen[-20:])
            try:
                x = self.q.get(timeout=left)
            except queue.Empty:
                continue
            assert x is not None, (prefix, "stdout closed", self.seen[-20:])
            self.seen.append(x)
            if x.startswith(prefix):
                return x

    def rest(self, timeout=WAIT):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            try:
                x = self.q.get(timeout=max(end - time.monotonic(), 0.01))
            except queue.Empty:
                continue
            if x is None:
                return self.seen
            self.seen.append(x)
        raise AssertionError(("stdout never closed", self.seen[-20:]))


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_queued_launcher_rolls_a_delta_and_drains(tmp_path):
    """``--frontend queued --stats-port 0 --delta-file``: /healthz answers
    ok, SIGHUP rolls a 1-edge reweight inside a served union (drain ->
    apply_edge_delta -> undrain), SIGTERM drains to exit 0 with the drain
    and SLA lines, and a relaunch on the spill dir restores entries."""
    n, e, roots = 3000, 24000, 5
    g = generate_webgraph(WebGraphSpec(n, e, 0.6, seed=0))
    stream = plaunch.zipf_query_stream(np.random.default_rng(0), n, 40,
                                       roots)
    fs = RankService(g, RankServiceConfig(device="cpu")).extractor.extract(
        np.unique(stream[0]))
    u, v = int(fs.nodes[fs.graph.src[0]]), int(fs.nodes[fs.graph.dst[0]])
    delta = tmp_path / "delta.json"
    delta.write_text(json.dumps({"reweights": [[u, v, 2.0]]}))
    spill = str(tmp_path / "spill")
    args = [sys.executable, "-m", "repro_torch.launch.serve_rank",
            "--device", "cpu", *GRAPH, "--requests", "3000", "--v", "4",
            "--frontend", "queued", "--arrival-qps", "100",
            "--low-pri-frac", "0.25", "--sla-ms", "1000",
            "--stats-port", "0", "--spill-dir", spill,
            "--delta-file", str(delta)]
    err = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, text=True,
                            stderr=err, env=env(), cwd=tmp_path)
    try:
        out = Lines(proc)
        port = int(out.wait_for("stats:").rsplit(":", 1)[1])
        out.wait_for("serving:")
        assert get(port, "/healthz") == (200, b"ok")
        proc.send_signal(signal.SIGHUP)
        roll = out.wait_for("delta roll:")
        assert "admission re-opened" in roll and "structural=False" in roll
        stats = json.loads(get(port, "/stats.json")[1])
        assert stats["queue"]["queue.drains"] >= 1
        proc.send_signal(signal.SIGTERM)
        seen = out.rest()
        rc = proc.wait(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        err.close()
    assert rc == 0, (tmp_path / "stderr.txt").read_text()[-3000:]
    text = "\n".join(seen)
    assert "drain: admission stopped" in text
    sla = [x for x in seen if x.startswith("sla:")]
    assert sla and re.search(r"class 0: \d+ submitted / \d+ served / 0 shed",
                             text), text
    again = launch("repro_torch.launch.serve_rank", "--device", "cpu", *GRAPH,
                   "--requests", "8", "--v", "4", "--spill-dir", spill,
                   cwd=tmp_path)
    assert int(line(again, "spill: restored").split()[2]) >= 1


def test_helpers_match_reference(tmp_path):
    """The Zipf stream, the delta-file parser and the drain -> delta ->
    undrain roll give what the reference's give."""
    for seed in (0, 3):
        a = plaunch.zipf_query_stream(np.random.default_rng(seed), 500, 30,
                                      5, vocab=16)
        b = rlaunch.zipf_query_stream(np.random.default_rng(seed), 500, 30,
                                      5, vocab=16)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    f = tmp_path / "d.json"
    f.write_text(json.dumps({"reweights": [[1, 2, 2.0]], "removes": []}))
    assert plaunch.load_delta_file(str(f)) == rlaunch.load_delta_file(str(f))
    f.write_text(json.dumps({"moves": []}))
    for mod in (plaunch, rlaunch):
        with pytest.raises(ValueError, match="unknown keys"):
            mod.load_delta_file(str(f))

    rg = ref_generate(RefSpec(800, 6000, 0.5, seed=1))
    rng = np.random.default_rng(4)
    qs = [rng.choice(800, size=4, replace=False) for _ in range(6)]
    out = []
    # depth 1: a batch's warm starts never depend on arrival timing
    for svc in (RefService(rg, RefConfig(v_max=4, tol=1e-12,
                                         pipeline_depth=1)),
                RankService(from_reference(rg), RankServiceConfig(
                    device="cpu", v_max=4, tol=1e-12, pipeline_depth=1))):
        fs = svc.extractor.extract(np.unique(qs[0]))
        u, v = int(fs.nodes[fs.graph.src[0]]), int(fs.nodes[fs.graph.dst[0]])
        mod = plaunch if isinstance(svc, RankService) else rlaunch
        q = svc.queue(deadline_ms=60_000)
        try:
            tickets = [q.submit(x) for x in qs]
            draining = threading.Event()
            d, s = mod.roll_delta(svc, q, {"reweights": [(u, v, 2.0)]},
                                  draining)
            assert not draining.is_set()
            after = [q.submit(x) for x in qs[:2]]
        finally:  # close() serves what is pending
            q.close(wait=False)
            q._thread.join(timeout=WAIT)
            q.flush()
        res = [t.result(timeout=WAIT) for t in tickets + after]
        s.pop("swap_ms")
        out.append((d, s, [(r.status, r.iters) for r in res]))
    assert out[0] == out[1]


def test_sharded_backend_and_missing_card_raise(tmp_path, monkeypatch):
    """``--backend sharded --shard-devices 2 --device cpu`` serves what the
    reference's launcher serves with the same flags (its mesh over 2
    forced host devices, the port's 2 shards on the host): equal graph,
    cache, plan and iterated-queries lines and the same sample top-k.
    Without ``--device cpu`` the launcher wants the card and raises
    without one."""
    args = GRAPH + ["--requests", "40", "--v", "4", "--backend", "sharded",
                    "--shard-devices", "2"]
    outs = {}
    for name, module in (("ref", "repro.launch.serve_rank"),
                         ("port", "repro_torch.launch.serve_rank")):
        extra = ["--device", "cpu"] if name == "port" else []
        r = subprocess.run(
            [sys.executable, "-m", module, *args, *extra],
            capture_output=True, text=True, cwd=tmp_path, timeout=WAIT,
            env=dict(env(), XLA_FLAGS="--xla_force_host_platform_device_"
                                      "count=2"))
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
        outs[name] = r.stdout
    r, p = outs["ref"], outs["port"]
    for prefix in ("graph:", "cache:", "plans:", "iterated queries:"):
        assert line(p, prefix) == line(r, prefix), prefix
    rr, rs, rk = topk(r)
    pr, ps, pk = topk(p)
    assert (pr, ps) == (rr, rs)
    assert [n for n, _ in pk] == [n for n, _ in rk]
    assert max(abs(a - b) for (_, a), (_, b) in zip(pk, rk)) <= 1e-9
    small = ["serve_rank", "--dataset", "synthetic", "--n-nodes", "200",
             "--n-edges", "1000", "--requests", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--backend", "sharded"]):
        monkeypatch.setattr(sys, "argv", small + extra)
        with pytest.raises(RuntimeError, match="cuda"):
            plaunch.main()


# ------------------------------------------------------- launch.train
TRAIN = ["--smoke", "--steps", "6", "--batch", "8", "--ckpt-every", "3"]


def ckpt_arrays(d, step):
    with np.load(Path(d) / f"step_{step:010d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ["dlrm-rm2", "dcn-v2", "bst",
                                  "two-tower-retrieval"])
def test_train_launcher_each_recsys_arch(arch, tmp_path):
    """``--arch <recsys> --smoke`` on the CPU: the reference's step lines
    (steps 0 and the last), finite losses, the ``timing:`` line; the
    checkpoint holds the keys, shapes and dtypes of the reference's
    ``{"params", "opt"}`` tree (what ``repro.launch.train`` saves)."""
    import jax
    from repro.checkpoint import checkpoint as rck
    from repro.configs import get_spec as ref_spec
    from repro.models import recsys as rs
    from repro.train import init_opt_state as ref_init_opt
    out = launch("repro_torch.launch.train", "--arch", arch, *TRAIN,
                 "--device", "cpu", "--ckpt", str(tmp_path / "p"),
                 cwd=tmp_path)
    steps = re.findall(r"step\s+(\d+) loss (\S+) lr (\S+) gnorm (\S+)", out)
    assert [int(s[0]) for s in steps] == [0, 5]
    assert all(np.isfinite(float(s[1])) for s in steps)
    assert "done: 6 steps" in out and "timing: step ms median" in out
    cfg = ref_spec(arch).smoke_config
    init = {"dlrm-rm2": rs.init_dlrm_params, "dcn-v2": rs.init_dcn_params,
            "bst": rs.init_bst_params,
            "two-tower-retrieval": rs.init_twotower_params}[arch]
    params = init(cfg, jax.random.key(0))
    want = rck._flatten({"params": params, "opt": ref_init_opt(params)})
    got = ckpt_arrays(tmp_path / "p", 6)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
    assert int(got["k=opt::k=step"]) == 6


def test_train_launcher_resumes_its_own_checkpoint(tmp_path):
    """bst: 6 steps with a checkpoint every 3, then ``--resume`` to 9
    steps starts after step 6 and writes step 9."""
    ck = str(tmp_path / "ck")
    launch("repro_torch.launch.train", "--arch", "bst", *TRAIN, "--device",
           "cpu", "--ckpt", ck, cwd=tmp_path)
    out = launch("repro_torch.launch.train", "--arch", "bst", "--smoke",
                 "--steps", "9", "--batch", "8", "--ckpt-every", "3",
                 "--device", "cpu", "--ckpt", ck, "--resume", cwd=tmp_path)
    assert "resumed from step 6" in out and "done: 3 steps" in out
    assert int(ckpt_arrays(ck, 9)["k=opt::k=step"]) == 9


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_train_checkpoint_crosses_packages(writer, tmp_path):
    """A checkpoint written by either package's ``launch.train`` resumes
    in the other: restored parameters, moments and step equal the file bit
    for bit, and the other launcher continues from it."""
    import jax
    from repro.checkpoint import checkpoint as rck
    from repro.models import recsys as rs
    from repro.train import init_opt_state as ref_init_opt
    from repro_torch.configs import get_spec
    from repro_torch.launch import train as ptrain
    from repro_torch.train import init_opt_state
    from repro_torch.tree import leaves
    ck = str(tmp_path / "ck")
    dev = ["--device", "cpu"] if writer == "repro_torch" else []
    launch(f"{writer}.launch.train", "--arch", "bst", *TRAIN, "--ckpt", ck,
           *dev, cwd=tmp_path)
    arrays = ckpt_arrays(ck, 6)
    cfg = get_spec("bst").smoke_config
    if writer == "repro":
        model, _loss, _bf = ptrain.model_and_data(cfg, 8, seed=5,
                                                  device="cpu")
        opt = init_opt_state(model)
        assert ptrain.restore(ck, model, opt) == 6
        tree = ptrain.checkpoint_tree(model, opt)
        from repro_torch.checkpoint import checkpoint as pck
        flat = pck._flatten(tree)
        assert list(flat) == list(arrays)
        for k in arrays:
            assert flat[k].dtype == arrays[k].dtype and \
                np.array_equal(flat[k], arrays[k]), k
        assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 6
        assert all(p.dtype == torch.float32 for p in leaves(model.to_tree()))
        other = ["repro_torch.launch.train", "--device", "cpu"]
    else:
        params = rs.init_bst_params(cfg, jax.random.key(9))
        tree, step, _ = rck.restore(ck, {"params": params,
                                         "opt": ref_init_opt(params)})
        assert step == 6
        flat = rck._flatten(tree)
        assert list(flat) == list(arrays)
        for k in arrays:
            assert np.array_equal(np.asarray(flat[k]), arrays[k]), k
        other = ["repro.launch.train"]
    out = launch(other[0], "--arch", "bst", "--smoke", "--steps", "9",
                 "--batch", "8", "--ckpt-every", "3", "--ckpt", ck,
                 "--resume", *other[1:], cwd=tmp_path)
    assert "resumed from step 6" in out and "done: 3 steps" in out


def test_train_launcher_refusals(tmp_path, monkeypatch, capsys):
    """An LM arch and the GNN arch train (the GNN as a subprocess, with
    the reference's ``step``/``done:`` lines); the ranking arch is sent
    to launch.rank as the reference does; without ``--device cpu`` and no
    card it raises, for the GNN too."""
    from repro_torch.launch import train as ptrain
    for arch in ("deepseek-7b", "gin-tu"):
        if arch == "deepseek-7b":
            ptrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "1", "--batch", "2", "--seq", "8"])
            assert "done: 1 steps" in capsys.readouterr().out
            continue
        out = launch("repro_torch.launch.train", "--arch", arch, "--smoke",
                     "--device", "cpu", "--steps", "1", cwd=tmp_path)
        assert re.search(r"^step +0 loss [0-9.]+ lr [0-9.e+-]+ gnorm "
                         r"[0-9.]+$", out, re.M) and "done: 1 steps" in out, \
            out
    with pytest.raises(SystemExit, match="launch.rank"):
        ptrain.main(["--arch", "hits-webgraph", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("bst", "gin-tu"):
        with pytest.raises(RuntimeError, match="cuda"):
            ptrain.main(["--arch", arch, "--smoke", "--steps", "1"])


# --------------------------------------------------------- the LM family
LM_ARCHS = ("deepseek-v2-236b", "mixtral-8x7b", "deepseek-7b",
            "minitron-4b", "minitron-8b")
SERVE_LINES = (r"arch=(\S+) batch=4 prompt=8 gen=16 tokens",
               r"throughput: [0-9.]+ tok/s \((.+)\)",
               r"  seq0: (\[.*\]) -> (\[.*\])",
               r"  seq1: (\[.*\]) -> (\[.*\])")


def serve_lines(out, name, vocab):
    """The reference's three kinds of line: the shape, the throughput, two
    sample sequences (8 prompt tokens -> 16 generated, all in vocab)."""
    lines = out.splitlines()
    assert len(lines) == 4, out
    ms = [re.fullmatch(p, x) for p, x in zip(SERVE_LINES, lines)]
    assert all(ms), out
    assert ms[0].group(1) == name
    for m in ms[2:]:
        prompt, gen = ast.literal_eval(m.group(1)), \
            ast.literal_eval(m.group(2))
        assert len(prompt) == 8 and len(gen) == 16
        assert all(0 <= t < vocab for t in prompt + gen)
    return ms[1].group(1)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_launcher_each_lm_arch(arch, tmp_path):
    """``python -m repro_torch.launch.serve --arch <lm> --smoke --device
    cpu`` prints the reference's lines (the reference's own launcher is
    held to the same format for its default arch)."""
    from repro_torch.configs import get_spec
    cfg = get_spec(arch).smoke_config
    out = launch("repro_torch.launch.serve", "--arch", arch, "--smoke",
                 "--device", "cpu", cwd=tmp_path)
    assert serve_lines(out, cfg.name, cfg.vocab) == "host CPU"
    if arch == "mixtral-8x7b":
        ref = launch("repro.launch.serve", "--arch", arch, "--smoke",
                     cwd=tmp_path)
        assert serve_lines(ref, cfg.name, cfg.vocab) == "host devices"


def test_serve_launcher_refusals(tmp_path):
    """A recsys arch and the GNN arch are refused with the reference's
    message."""
    for arch, msg in (("bst", "decode serving applies to LM archs"),
                      ("gin-tu", "decode serving applies to LM archs")):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--smoke", "--device", "cpu"], capture_output=True,
            text=True, env=env(), cwd=tmp_path, timeout=WAIT)
        assert r.returncode != 0 and msg in r.stderr, r.stderr


LM_TRAIN = ["--arch", "deepseek-7b", "--smoke", "--steps", "6", "--batch",
            "4", "--seq", "16", "--ckpt-every", "3"]


def lm_like():
    import jax
    from repro.configs import get_spec as ref_spec
    from repro.models import transformer as rt
    from repro.train import init_opt_state as ref_init_opt
    params = rt.init_params(ref_spec("deepseek-7b").smoke_config,
                            jax.random.key(9))
    return {"params": params, "opt": ref_init_opt(params)}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_lm_train_checkpoint_crosses_packages(writer, tmp_path):
    """``launch.train --arch deepseek-7b --smoke``: the reference's step
    lines; the checkpoint holds the reference's ``{"params", "opt"}``
    keys, shapes and dtypes; a checkpoint written by either package
    restores in the other bit for bit, and the other launcher resumes
    from it."""
    from repro.checkpoint import checkpoint as rck
    from repro_torch.checkpoint import checkpoint as pck
    from repro_torch.configs import get_spec
    from repro_torch.launch import train as ptrain
    from repro_torch.train import init_opt_state
    ck = str(tmp_path / "ck")
    dev = ["--device", "cpu"] if writer == "repro_torch" else []
    out = launch(f"{writer}.launch.train", *LM_TRAIN, "--ckpt", ck, *dev,
                 cwd=tmp_path)
    steps = re.findall(r"step\s+(\d+) loss (\S+) lr (\S+) gnorm (\S+)", out)
    assert [int(s[0]) for s in steps] == [0, 5]
    assert all(np.isfinite(float(s[1])) for s in steps)
    arrays = ckpt_arrays(ck, 6)
    want = rck._flatten(lm_like())
    assert list(arrays) == list(want)
    for k in want:
        assert arrays[k].shape == want[k].shape and \
            arrays[k].dtype == want[k].dtype, k
    if writer == "repro":
        cfg = get_spec("deepseek-7b").smoke_config
        model, _loss, _bf = ptrain.model_and_data(cfg, 4, seed=5,
                                                  device="cpu", seq=16)
        opt = init_opt_state(model)
        assert ptrain.restore(ck, model, opt) == 6
        flat = pck._flatten(ptrain.checkpoint_tree(model, opt))
        other = ["repro_torch.launch.train", "--device", "cpu"]
    else:
        tree, step, _ = rck.restore(ck, lm_like())
        assert step == 6
        flat = {k: np.asarray(v) for k, v in rck._flatten(tree).items()}
        other = ["repro.launch.train"]
    assert list(flat) == list(arrays)
    for k in arrays:
        assert np.array_equal(flat[k], arrays[k]), k
    out = launch(other[0], *LM_TRAIN[:3], "--steps", "9",
                 *LM_TRAIN[5:], "--ckpt", ck, "--resume", *other[1:],
                 cwd=tmp_path)
    assert "resumed from step 6" in out and "done: 3 steps" in out
    if writer == "repro":
        assert "timing: step ms median" in out
