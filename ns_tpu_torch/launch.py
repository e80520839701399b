"""Multi-process launcher: `python -m ns_tpu_torch.launch`.

Port of `ns_tpu/launch.py`. Spawns N copies of a worker command with the
bootstrap variables set: the JAX package's NS_TPU_* (coordinator address
on a free local port, process id, process count, platform), which
`ns_tpu_torch.parallel.distributed.initialize_from_env()` reads, and
torchrun's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK. Each worker
is one rank with one device: NCCL on cuda:LOCAL_RANK (--platform cuda, the
default), gloo on the CPU (--platform cpu). A torch rank owns one device,
so --devices-per-proc other than 1 is refused; on cuda, --nprocs above the
number of cards is refused at once (NCCL rejects two ranks on one GPU).

Usage:
  python -m ns_tpu_torch.launch --nprocs 4 --platform cpu -- \\
      python my_worker.py --args...

  # the built-in validation (halo exchange, distributed matmul-DFT,
  # all-reduce, per-rank sharded output):
  python -m ns_tpu_torch.launch --nprocs 2 --platform cpu --selftest
  python -m ns_tpu_torch.launch --nprocs 1 --selftest   # on the card

Child output is streamed with a `[p{i}]` prefix; the launcher exits with
the first nonzero child return code (signal deaths included) and
terminates the other children; --timeout ends the gang with 124.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time

ONE_DEVICE = ("a torch rank owns one device: run one process per device "
              "(--nprocs), not several devices per process")


def _free_port() -> int:
    # the port is only probably free: the probe socket closes before rank 0
    # binds it; concurrent launches on one host can still collide, and
    # then the gang fails fast
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pump(stream, prefix: str, out):
    """Drain a child's output (children block on a full pipe otherwise);
    out=None discards lines."""
    for line in iter(stream.readline, ""):
        if out is not None:
            out.write(f"{prefix} {line}")
            out.flush()
    stream.close()


def check_platform(nprocs: int, platform: str) -> str | None:
    """Why a gang of nprocs ranks cannot run on `platform`, or None."""
    if platform == "cpu":
        return None
    import torch
    if not torch.cuda.is_available():
        return ("no CUDA device is available; pass --platform cpu to run "
                "the gang on the CPU")
    n = torch.cuda.device_count()
    if nprocs > n:
        return (f"--nprocs {nprocs} needs {nprocs} CUDA devices, this "
                f"machine has {n} (NCCL runs one rank a GPU; pass "
                "--platform cpu for a CPU gang)")
    return None


def launch(cmd: list[str], nprocs: int, platform: str = "cuda",
           coordinator: str | None = None, env_extra: dict | None = None,
           quiet: bool = False, timeout: float | None = None) -> int:
    """Run `cmd` nprocs times with the bootstrap variables; return the
    first nonzero child return code (124 on timeout), else 0."""
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    addr, port = coordinator.rsplit(":", 1)
    procs = []
    threads = []
    rc = 0
    deadline = (time.monotonic() + timeout) if timeout else None
    try:
        # spawn inside the try: a failed Popen for a later worker must not
        # leak earlier children (they wait in init_process_group for the
        # whole gang)
        for pid in range(nprocs):
            env = dict(os.environ)
            env.update({
                "NS_TPU_COORDINATOR": coordinator,
                "NS_TPU_NUM_PROCESSES": str(nprocs),
                "NS_TPU_PROCESS_ID": str(pid),
                "NS_TPU_PLATFORM": platform,
                "NS_TPU_LOCAL_DEVICES": "1",
                "MASTER_ADDR": addr, "MASTER_PORT": port,
                "RANK": str(pid), "WORLD_SIZE": str(nprocs),
                "LOCAL_RANK": str(pid),
            })
            if env_extra:
                env.update(env_extra)
            p = subprocess.Popen(cmd, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs.append(p)
            t = threading.Thread(
                target=_pump, args=(p.stdout, f"[p{pid}]",
                                    None if quiet else sys.stdout),
                daemon=True)
            t.start()
            threads.append(t)

        # poll every child in turn (never block on one in pid order: a
        # later worker crashing while an earlier one waits in a collective
        # would hang a pid-ordered wait forever)
        live = list(procs)
        while live and rc == 0:
            for p in list(live):
                ret = p.poll()
                if ret is None:
                    continue
                live.remove(p)
                if ret != 0:
                    # signal deaths are negative return codes: any nonzero
                    # code (either sign) fails the gang
                    rc = ret
                    break
            if deadline and time.monotonic() > deadline:
                rc = 124
                break
            if live and rc == 0:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=5)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ns_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nprocs", type=int, required=True,
                    help="number of worker processes (ranks) to spawn")
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="accepted for the JAX launcher's command lines; "
                         "only 1 (a torch rank owns one device)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): NCCL, one card a rank; cpu: gloo")
    ap.add_argument("--selftest", action="store_true",
                    help="run the built-in multi-process validation "
                         "worker instead of a user command")
    ap.add_argument("--timeout", type=float, default=None,
                    help="wall-clock limit of the gang in seconds")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (prefix with --)")
    args = ap.parse_args(argv)

    if args.devices_per_proc not in (None, 1):
        ap.error(f"--devices-per-proc {args.devices_per_proc}: {ONE_DEVICE}")
    if args.nprocs < 1:
        ap.error(f"--nprocs must be >= 1, got {args.nprocs}")
    if args.selftest:
        cmd = [sys.executable, "-m", "ns_tpu_torch.cli.dist_selftest"]
    else:
        cmd = args.cmd
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        if not cmd:
            ap.error("no worker command given (and --selftest not set)")
    why = check_platform(args.nprocs, args.platform)
    if why:
        ap.error(why)

    rc = launch(cmd, args.nprocs, platform=args.platform,
                timeout=args.timeout)
    if rc == 0:
        print(f"launch: all {args.nprocs} processes exited cleanly")
    else:
        print(f"launch: FAILED (rc={rc})", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
