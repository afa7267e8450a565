#!/usr/bin/env python
"""Serve concurrency smoke of the port's daemon at production shape (the
port of tools/serve_concurrency_smoke.py, importing no JAX).

Concurrent socket clients send batch-sized requests to a live
`serve_torch.py` daemon; their outputs must be byte-equal to a serial replay
of the same requests, in the order the daemon processed them, on a fresh
daemon (same seed, same stream of draws; the daemon's lock serializes the
device work, so the processing order fixes the outputs).

Phases, one daemon at a time:
  1. `-u 1` DDRM daemon (deno, --t-start auto), batch 64: two clients
     interleave 64-measurement (4096-dim) restoration requests.
  2. `-u 0` conditional daemon (--t-start auto --sampling-steps 4, the
     deterministic DDIM config): two clients interleave 64-patch requests.

For each phase: the concurrent pass (its processing order is the order the
responses arrive: the lock serializes them), a fresh daemon's serial replay
in that order, and the outputs compared byte for byte. Each request's wall
time is kept: serial ones as the solo latency, concurrent ones beside them.
Each daemon's kernel launches (from its ping) show the requests went through
the kernels. A daemon is killed if anything fails while it runs.

Usage:
  python tools/torch_serve_concurrency_smoke.py --ddrm-weights <uncond_ckpt> \
      --cond-weights <cond_ckpt> [--sigma 0.1] [--batch 64] [--device cuda]
  python tools/torch_serve_concurrency_smoke.py --toy --device cpu
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hicdiff_tpu_torch.serve import request  # noqa: E402  (the client side)


def start_daemon(args, sock, log_path, timeout=1200.0):
    """A serve_torch.py daemon on `sock`, once it answers a ping; killed if
    it does not come up."""
    with open(log_path, "a") as log:
        proc = subprocess.Popen([sys.executable, os.path.join(REPO, "serve_torch.py"),
                                 "--socket", sock] + args,
                                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.time()
    try:
        while time.time() - t0 < timeout:
            if proc.poll() is not None:
                with open(log_path) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"daemon exited rc={proc.returncode}; {log_path} ends:\n{tail}")
            try:
                if request(sock, {"id": -1, "op": "ping"}, timeout=10).get("ok"):
                    return proc
            except (FileNotFoundError, ConnectionRefusedError, OSError):
                time.sleep(0.5)
        raise TimeoutError(f"daemon not ready after {timeout}s; see {log_path}")
    except BaseException:
        kill(proc)
        raise


def kill(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def stop_daemon(proc, sock):
    """Shut the daemon down by request and return its kernel launches; it is
    killed if it does not exit within a minute."""
    try:
        launches = request(sock, {"id": -3, "op": "ping"}, timeout=60)["launches"]
        request(sock, {"id": -2, "op": "shutdown"}, timeout=60)
        proc.wait(timeout=60)
        return launches
    finally:
        kill(proc)


def _send(sock, rname, src, out):
    t0 = time.time()
    resp = request(sock, {"id": rname, "op": "denoise", "npy": src, "out": out}, timeout=1200)
    if not resp.get("ok"):
        raise RuntimeError(f"{rname}: {resp}")
    return time.time() - t0


def run_phase(name, daemon_args, inputs, workdir):
    """inputs: {request name: array}. Returns the phase's record: the
    processing order, the concurrent and solo (serial) request walls, and
    each daemon's kernel launches."""
    sock = os.path.join(workdir, f"{name}.sock")
    log = os.path.join(workdir, f"daemon_{name}.log")
    reqs = {}
    for rname, arr in inputs.items():
        reqs[rname] = os.path.join(workdir, f"{name}_{rname}.npy")
        np.save(reqs[rname], arr)

    # ---- concurrent pass: two clients, each with its half of the requests
    print(f"[{name}] starting daemon (concurrent pass)...", flush=True)
    proc = start_daemon(daemon_args, sock, log)
    done, errors, lock = [], [], threading.Lock()

    def client(cname, rnames):
        try:
            for rname in rnames:
                dt = _send(sock, rname, reqs[rname],
                           os.path.join(workdir, f"{name}_{rname}_conc.npy"))
                with lock:
                    done.append((time.time(), rname, dt))
                print(f"[{name}] client {cname} <- {rname}: wall {dt:.3f}s", flush=True)
        except Exception as e:  # reported after the join, with the other client's
            errors.append(f"{cname}: {type(e).__name__}: {e}")

    try:
        rnames = sorted(inputs)
        half = (len(rnames) + 1) // 2
        threads = [threading.Thread(target=client, args=("A", rnames[:half])),
                   threading.Thread(target=client, args=("B", rnames[half:]))]
        t_conc = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2400)
        t_conc = time.time() - t_conc
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"[{name}] concurrent clients failed: {errors}")
        conc_launches = stop_daemon(proc, sock)
    finally:
        kill(proc)
    order = [rname for _, rname, _ in sorted(done)]
    print(f"[{name}] concurrent pass done in {t_conc:.1f}s; processing order: {order}",
          flush=True)

    # ---- serial replay on a fresh daemon (a fresh count of draws), in that order
    print(f"[{name}] starting fresh daemon (serial replay)...", flush=True)
    proc = start_daemon(daemon_args, sock, log)
    try:
        solo = [_send(sock, rname, reqs[rname],
                      os.path.join(workdir, f"{name}_{rname}_serial.npy")) for rname in order]
        serial_launches = stop_daemon(proc, sock)
    finally:
        kill(proc)

    for rname in order:
        a = np.load(os.path.join(workdir, f"{name}_{rname}_conc.npy"))
        b = np.load(os.path.join(workdir, f"{name}_{rname}_serial.npy"))
        if not (a.shape == b.shape and np.array_equal(a, b)):
            raise AssertionError(f"[{name}] {rname}: concurrent != serial replay "
                                 f"(max abs diff {np.max(np.abs(a - b))})")
    print(f"[{name}] OK: all {len(order)} concurrent responses byte-equal to the serial "
          "replay", flush=True)
    return {"order": order, "concurrent_wall_s": [dt for _, _, dt in sorted(done)],
            "solo_wall_s": solo, "concurrent_pass_s": t_conc,
            "launches_concurrent": conc_launches, "launches_serial": serial_launches}


def card_name(device):
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ddrm-weights", default=None)
    ap.add_argument("--cond-weights", default=None)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--schedule-cond", default="sigmoid")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests-per-client", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="the daemons' device (default cuda)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--toy", action="store_true",
                    help="a tiny random-init backbone (blocks=2, features=16, T=8) at batch 4, "
                         "for rehearsing the harness on the CPU (with --device cpu)")
    args = ap.parse_args(argv)
    if not args.toy and not (args.ddrm_weights and args.cond_weights):
        ap.error("--ddrm-weights/--cond-weights required (or pass --toy)")
    bf16 = not args.toy  # bf16 daemons, as the JAX tool's
    common = ["--device", args.device] + (["--bf16"] if bf16 else [])
    toy = []
    if args.toy:
        args.batch = 4
        toy = ["--blocks", "2", "--features", "16", "--timestep", "8"]
    own = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="hicdiff_torch_serve_smoke_")
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0)
    n_req = 2 * args.requests_per_client
    try:
        # phase 1: DDRM, 64-measurement (4096-dim) requests at the service batch
        ddrm_inputs = {f"r{i}": np.clip(rng.normal(0, 0.3, (args.batch, 64 * 64)), -1, 1
                                        ).astype(np.float32) for i in range(n_req)}
        ddrm_daemon = common + ["-u", "1", "-s", str(args.sigma), "--schedule", "linear",
                                "--batch", str(args.batch), "--t-start", "auto"]
        ddrm_daemon += toy if args.toy else ["--weights", args.ddrm_weights]
        ddrm = run_phase("ddrm", ddrm_daemon, ddrm_inputs, workdir)

        # phase 2: conditional truncated DDIM (deterministic), 64-patch requests
        cond_inputs = {f"r{i}": np.clip(rng.normal(0, 0.3, (args.batch, 1, 64, 64)), -1, 1
                                        ).astype(np.float32) for i in range(n_req)}
        cond_daemon = common + ["-s", str(args.sigma), "--schedule", args.schedule_cond,
                                "--batch", str(args.batch)]
        cond_daemon += (toy + ["--t-start", "2", "--sampling-steps", "2"] if args.toy else
                        ["--weights", args.cond_weights, "--t-start", "auto",
                         "--sampling-steps", "4"])
        cond = run_phase("cond", cond_daemon, cond_inputs, workdir)
        record = {"ok": True, "card": card_name(args.device), "batch": args.batch,
                  "dtype": "bfloat16" if bf16 else "float32",
                  "requests_per_client": args.requests_per_client, "ddrm": ddrm, "cond": cond}
        print(json.dumps(record), flush=True)
        return record
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
