"""Cluster launcher: the tracker reborn (reference tracker/{tracker.py,
dmlc_local.py,dmlc_ssh.py,dmlc_mpi.py}; the JAX package's launcher.py).

Spawns N copies of a program with the env contract consumed by
`adapm_tpu_torch.parallel.control.init_from_env` (ADAPM_COORDINATOR /
ADAPM_NUM_PROCESSES / ADAPM_PROCESS_ID — the analog of the reference's
DMLC_PS_ROOT_URI/PORT + DMLC_ROLE env rendezvous, docs/env.md). There is no
separate scheduler process: process 0 hosts the control plane's
`torch.distributed.TCPStore` at the coordinator address.

Modes:
  local  N subprocesses on this machine (reference dmlc_local.py), with the
         keepalive contract: a process exiting with code 254 is restarted
         (dmlc_local.py:15-25).
  ssh    fan out over ssh using a hostfile, one process per line
         (reference dmlc_ssh.py).
  mpi    delegate process placement to mpirun (reference dmlc_mpi.py).

Usage: python -m adapm_tpu_torch.launcher -n 2 -- python my_app.py --epochs 4
"""
from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

KEEPALIVE_EXIT_CODE = 254  # reference dmlc_local.py restart contract


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def make_env(rank: int, num: int, coordinator: str,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(base if base is not None else os.environ)
    env["ADAPM_COORDINATOR"] = coordinator
    env["ADAPM_NUM_PROCESSES"] = str(num)
    env["ADAPM_PROCESS_ID"] = str(rank)
    return env


def launch_local(n: int, cmd: List[str], keepalive: bool = True,
                 coordinator: Optional[str] = None,
                 max_restarts: int = 8,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0) -> int:
    """Run n copies locally; returns the first nonzero exit code (0 if all
    succeed). Keepalive restarts rank processes that exit with 254 —
    with capped exponential backoff and a max-restart budget (the
    reference dmlc_local.py contract restarts forever at a fixed 0.5 s
    cadence, so a rank that crashes at startup would hot-loop; here
    restart k waits min(backoff_base * 2^k, backoff_max) and after
    `max_restarts` restarts the rank's 254 is propagated as the job's
    failure code instead of looping)."""
    coordinator = coordinator or f"localhost:{free_port()}"
    codes = [0] * n
    threads = []

    def run(rank: int) -> None:
        restarts = 0
        while True:
            p = subprocess.Popen(cmd, env=make_env(rank, n, coordinator))
            p.wait()
            if keepalive and p.returncode == KEEPALIVE_EXIT_CODE:
                if restarts >= max_restarts:
                    print(f"[launcher] rank {rank} exhausted its "
                          f"restart budget ({max_restarts}): crash "
                          f"loop — giving up with exit code "
                          f"{p.returncode}", file=sys.stderr)
                    codes[rank] = p.returncode
                    return
                delay = min(backoff_max_s,
                            backoff_base_s * (2.0 ** restarts))
                restarts += 1
                time.sleep(delay)
                continue
            codes[rank] = p.returncode
            return

    for r in range(n):
        t = threading.Thread(target=run, args=(r,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    return next((c for c in codes if c != 0), 0)


def remote_port(seed: Optional[int] = None) -> int:
    """A port for a coordinator that binds on a REMOTE machine: probing a
    local free port (free_port) says nothing about the remote host, so pick
    from a high range instead; pass --coordinator-port to pin one."""
    import random
    return random.Random(seed).randint(20000, 39999)


def launch_ssh(hosts: List[str], cmd: List[str], coordinator_port: int = 0,
               ssh_opts: str = "-o StrictHostKeyChecking=no") -> int:
    """One process per host line (reference dmlc_ssh.py). The first host
    runs process 0 and the coordinator."""
    n = len(hosts)
    port = coordinator_port or remote_port()
    coordinator = f"{hosts[0]}:{port}"
    procs = []
    for rank, host in enumerate(hosts):
        envs = " ".join(
            f"{k}={shlex.quote(v)}"
            for k, v in [("ADAPM_COORDINATOR", coordinator),
                         ("ADAPM_NUM_PROCESSES", str(n)),
                         ("ADAPM_PROCESS_ID", str(rank))])
        remote = f"cd {shlex.quote(os.getcwd())} && {envs} " + \
            " ".join(shlex.quote(c) for c in cmd)
        procs.append(subprocess.Popen(
            ["ssh"] + ssh_opts.split() + [host, remote]))
    code = 0
    for p in procs:
        p.wait()
        code = code or p.returncode
    return code


def launch_mpi(n: int, cmd: List[str], mpirun: str = "mpirun",
               coordinator_port: int = 0) -> int:
    """Delegate to mpirun (reference dmlc_mpi.py): ranks come from
    OMPI_COMM_WORLD_RANK et al; we translate via a tiny bootstrap that maps
    MPI env to the ADAPM contract. Rank 0 may land on another host, so the
    coordinator port comes from remote_port()."""
    coordinator = f"{socket.gethostname()}:{coordinator_port or remote_port()}"
    boot = (
        "import os,subprocess,sys;"
        "r=os.environ.get('OMPI_COMM_WORLD_RANK') or "
        "os.environ.get('PMI_RANK') or '0';"
        f"os.environ['ADAPM_COORDINATOR']='{coordinator}';"
        f"os.environ['ADAPM_NUM_PROCESSES']='{n}';"
        "os.environ['ADAPM_PROCESS_ID']=r;"
        f"sys.exit(subprocess.call({cmd!r}))")
    return subprocess.call([mpirun, "-n", str(n), sys.executable, "-c", boot])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-n", "--num-processes", type=int, default=1)
    parser.add_argument("--mode", choices=["local", "ssh", "mpi"],
                        default="local")
    parser.add_argument("--hostfile", default=None,
                        help="ssh mode: one host per line")
    parser.add_argument("--coordinator-port", type=int, default=0,
                        help="pin the coordinator port (ssh/mpi modes)")
    parser.add_argument("--no-keepalive", action="store_true")
    parser.add_argument("--max-restarts", type=int, default=8,
                        help="local mode: keepalive restart budget per "
                        "rank before a crash-looping 254 propagates")
    parser.add_argument("--restart-backoff", type=float, default=0.5,
                        help="local mode: base seconds of the capped "
                        "exponential keepalive restart backoff")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="program to launch (prefix with --)")
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("no command given")
    if args.mode == "local":
        return launch_local(args.num_processes, cmd,
                            keepalive=not args.no_keepalive,
                            max_restarts=args.max_restarts,
                            backoff_base_s=args.restart_backoff)
    if args.mode == "ssh":
        with open(args.hostfile) as f:
            hosts = [h.strip() for h in f if h.strip()]
        return launch_ssh(hosts, cmd, coordinator_port=args.coordinator_port)
    return launch_mpi(args.num_processes, cmd,
                      coordinator_port=args.coordinator_port)


if __name__ == "__main__":
    sys.exit(main())
