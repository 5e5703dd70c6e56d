"""The port's launcher and control plane (adapm_tpu_torch/launcher.py,
parallel/control.py), twin of tests/test_launcher.py: the reference
tracker/dmlc_local.py thread-per-process launch, keepalive restart on
exit code 254 and its restart budget, the ssh and mpi shims, the
single-process fallbacks, and a real two-process barrier / allreduce /
broadcast over the TCPStore whose results are bitwise the JAX control
plane's float64 rank-order reduction."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from adapm_tpu_torch import launcher
from adapm_tpu_torch.parallel import control


def test_control_single_process_fallbacks():
    """All control primitives degrade to local no-ops in one process."""
    control.barrier("t")
    assert control.allreduce(3.0, "sum").tolist() == [3.0]
    assert control.allreduce([1.0, 2.0], "mean").tolist() == [1.0, 2.0]
    assert control.broadcast(np.arange(3)).tolist() == [0, 1, 2]
    assert control.num_processes() == 1
    assert control.process_id() == 0


def test_launch_local_env_contract(tmp_path):
    """launch_local spawns N ranks with the ADAPM_* env contract."""
    out = tmp_path / "ranks"
    out.mkdir()
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(f"""
        import os
        rank = os.environ["ADAPM_PROCESS_ID"]
        n = os.environ["ADAPM_NUM_PROCESSES"]
        coord = os.environ["ADAPM_COORDINATOR"]
        open(r"{out}" + "/" + rank, "w").write(n + " " + coord)
    """))
    code = launcher.launch_local(3, [sys.executable, str(script)])
    assert code == 0
    files = sorted(os.listdir(out))
    assert files == ["0", "1", "2"]
    contents = {(out / f).read_text() for f in files}
    assert len(contents) == 1  # same num + coordinator for all ranks


def test_launch_local_keepalive(tmp_path):
    """Exit code 254 triggers a restart (reference dmlc_local.py:15-25)."""
    marker = tmp_path / "ran_once"
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        m = r"{marker}"
        if not os.path.exists(m):
            open(m, "w").write("x")
            sys.exit(254)
        sys.exit(0)
    """))
    code = launcher.launch_local(1, [sys.executable, str(script)])
    assert code == 0 and marker.exists()


def test_launch_local_propagates_failure(tmp_path):
    script = tmp_path / "prog.py"
    script.write_text("import sys; sys.exit(7)")
    assert launcher.launch_local(
        2, [sys.executable, str(script)], keepalive=False) == 7


def test_launch_local_restart_budget_stops_crash_loop(tmp_path):
    """A rank that ALWAYS exits 254 used to be
    restarted forever at a fixed 0.5 s cadence (the reference
    dmlc_local.py contract). The hardened keepalive applies capped
    exponential backoff and gives up after the restart budget,
    propagating the 254 as the job's failure code."""
    import time as _time
    attempts = tmp_path / "attempts"
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        with open(r"{attempts}", "a") as f:
            f.write("x")
        sys.exit(254)
    """))
    t0 = _time.monotonic()
    code = launcher.launch_local(
        1, [sys.executable, str(script)], keepalive=True,
        max_restarts=3, backoff_base_s=0.01, backoff_max_s=0.04)
    elapsed = _time.monotonic() - t0
    # budget exhausted: the crash loop stops and the 254 surfaces
    assert code == launcher.KEEPALIVE_EXIT_CODE
    # initial run + exactly max_restarts restarts, never unbounded
    assert attempts.read_text() == "x" * 4
    # backoff actually waited: 0.01 + 0.02 + 0.04 (capped) >= 0.07 s
    assert elapsed >= 0.07


def test_launch_local_keepalive_still_recovers_within_budget(tmp_path):
    """A transiently-crashing rank (254 once, then clean) still
    recovers under the hardened keepalive — the budget bounds crash
    LOOPS, not legitimate restarts."""
    marker = tmp_path / "ran_once"
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        m = r"{marker}"
        if not os.path.exists(m):
            open(m, "w").write("x")
            sys.exit(254)
        sys.exit(0)
    """))
    code = launcher.launch_local(
        1, [sys.executable, str(script)], keepalive=True,
        max_restarts=3, backoff_base_s=0.01)
    assert code == 0 and marker.exists()


def _rank_recorder(tmp_path):
    """A program that records its ADAPM_* env, used to verify the env
    contract each launch mode assembles."""
    out = tmp_path / "ranks"
    out.mkdir(exist_ok=True)
    script = tmp_path / "prog.py"
    script.write_text(textwrap.dedent(f"""
        import os
        rank = os.environ["ADAPM_PROCESS_ID"]
        n = os.environ["ADAPM_NUM_PROCESSES"]
        coord = os.environ["ADAPM_COORDINATOR"]
        open(r"{out}" + "/" + rank, "w").write(n + " " + coord)
    """))
    return out, script


def test_launch_ssh_with_path_shim(tmp_path, monkeypatch):
    """ssh mode (reference tracker/dmlc_ssh.py): a PATH-shim `ssh` records
    argv and runs the remote command locally, verifying per-host command +
    env assembly without sshd."""
    out, script = _rank_recorder(tmp_path)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "ssh.log"
    shim = bin_dir / "ssh"
    # the remote command is the last argv; preceding args are opts + host
    shim.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        printf '%s\\n' "$*" >> {log}
        for last; do :; done
        exec sh -c "$last"
    """))
    shim.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    hosts = ["nodeA", "nodeB", "nodeC"]
    code = launcher.launch_ssh(hosts, [sys.executable, str(script)],
                               coordinator_port=23456)
    assert code == 0
    files = sorted(os.listdir(out))
    assert files == ["0", "1", "2"]
    contents = {(out / f).read_text() for f in files}
    # all ranks agree; coordinator is host 0 at the pinned port
    assert contents == {"3 nodeA:23456"}
    lines = log.read_text().splitlines()
    assert len(lines) == 3
    # the ssh processes run concurrently, so log lines may interleave in
    # any order — match each host's line by content, not position
    for rank, host in enumerate(hosts):
        ln = next(l for l in lines if f" {host} " in l)
        assert "StrictHostKeyChecking=no" in ln
        assert f"ADAPM_PROCESS_ID={rank}" in ln
        assert f"cd {os.getcwd()}" in ln


def test_launch_mpi_with_path_shim(tmp_path, monkeypatch):
    """mpi mode (reference tracker/dmlc_mpi.py): a PATH-shim `mpirun`
    records argv and spawns -n local copies with OMPI_COMM_WORLD_RANK set,
    verifying the MPI-env -> ADAPM-env bootstrap translation."""
    out, script = _rank_recorder(tmp_path)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "mpirun.log"
    shim = bin_dir / "mpirun"
    shim.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, subprocess, sys
        args = sys.argv[1:]
        open(r"{log}", "a").write(" ".join(args) + chr(10))
        n, cmd, i = 1, [], 0
        while i < len(args):
            if args[i] == "-n":
                n = int(args[i + 1]); i += 2
            else:
                cmd.append(args[i]); i += 1
        procs = []
        for r in range(n):
            env = dict(os.environ)
            env["OMPI_COMM_WORLD_RANK"] = str(r)
            procs.append(subprocess.Popen(cmd, env=env))
        code = 0
        for p in procs:
            p.wait(); code = code or p.returncode
        sys.exit(code)
    """))
    shim.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    code = launcher.launch_mpi(2, [sys.executable, str(script)],
                               coordinator_port=24567)
    assert code == 0
    files = sorted(os.listdir(out))
    assert files == ["0", "1"]
    contents = {(out / f).read_text() for f in files}
    assert len(contents) == 1  # same num + coordinator on every rank
    assert next(iter(contents)).startswith("2 ")
    assert ":24567" in next(iter(contents))
    assert "-n 2" in log.read_text()


def test_launcher_main_dispatches_all_modes(tmp_path, monkeypatch):
    """`python -m adapm_tpu_torch.launcher --mode {local,ssh,mpi}` reaches the
    right launch function with parsed hostfile/port/keepalive flags."""
    calls = {}
    monkeypatch.setattr(
        launcher, "launch_local",
        lambda n, cmd, keepalive=True, **kw: calls.setdefault(
            "local", (n, cmd, keepalive)) and 0 or 0)
    monkeypatch.setattr(
        launcher, "launch_ssh",
        lambda hosts, cmd, coordinator_port=0: calls.setdefault(
            "ssh", (hosts, cmd, coordinator_port)) and 0 or 0)
    monkeypatch.setattr(
        launcher, "launch_mpi",
        lambda n, cmd, coordinator_port=0: calls.setdefault(
            "mpi", (n, cmd, coordinator_port)) and 0 or 0)
    hostfile = tmp_path / "hosts"
    hostfile.write_text("a\nb\n")
    launcher.main(["-n", "4", "--no-keepalive", "--", "prog", "--x"])
    launcher.main(["--mode", "ssh", "--hostfile", str(hostfile),
                   "--coordinator-port", "2222", "--", "prog"])
    launcher.main(["--mode", "mpi", "-n", "3",
                   "--coordinator-port", "3333", "--", "prog"])
    assert calls["local"] == (4, ["prog", "--x"], False)
    assert calls["ssh"] == (["a", "b"], ["prog"], 2222)
    assert calls["mpi"] == (3, ["prog"], 3333)


def test_control_payload_framing():
    """dtype/shape ride the allreduce/broadcast payload; mismatches raise
    (the JAX control plane's framing, byte for byte)."""
    from adapm_tpu.parallel import control as jcontrol
    from adapm_tpu_torch.parallel.control import _pack_array, _unpack_array

    arr = np.arange(6, dtype=np.float64).reshape(2, 3)
    assert _pack_array(arr) == jcontrol._pack_array(arr)
    out = _unpack_array(_pack_array(arr), arr, "t")
    assert out.dtype == arr.dtype and (out == arr).all()
    out[0, 0] = -1  # writable copy
    for dt in (np.bool_, np.uint8):
        a = np.array([1, 0, 1, 1]).astype(dt)
        got = _unpack_array(jcontrol._pack_array(a), a, "t")
        assert got.dtype == a.dtype and (got == a).all()
    as_int = arr.astype(np.int64)
    with pytest.raises(ValueError, match="disagree"):
        _unpack_array(_pack_array(as_int), arr, "t")
    with pytest.raises(ValueError, match="disagree"):
        _unpack_array(_pack_array(arr.reshape(3, 2)), arr, "t")
    with pytest.raises(ValueError, match="bytes"):
        _unpack_array(_pack_array(arr)[:-8], arr, "t")


_TWO_RANK = """
import os, sys, faulthandler
faulthandler.dump_traceback_later(100, exit=True)
import numpy as np
from adapm_tpu_torch.parallel import control
assert control.init_from_env()
rank, n = control.process_id(), control.num_processes()
assert n == 2
control.barrier("start")
vals = np.random.default_rng(rank).standard_normal(17)
np.save(os.path.join(sys.argv[1], f"in{rank}.npy"), vals)
s = control.allreduce(vals, "sum")
m = control.allreduce(vals, "max", site="ar-max")
mean = control.allreduce(float(rank + 1), "mean", site="ar-mean")
b = control.broadcast(np.arange(5, dtype=np.int64) * (rank + 7), root=1)
for name, v in (("sum", s), ("max", m), ("mean", mean), ("bc", b)):
    np.save(os.path.join(sys.argv[1], f"{name}{rank}.npy"), v)
control.barrier("end")
print("RANK", rank, "OK", flush=True)
"""


def test_two_process_allreduce_broadcast_bitwise(tmp_path):
    """A real 2-process rendezvous through the TCPStore: allreduce
    sum/max/mean and broadcast agree on both ranks and equal, bit for
    bit, the JAX control plane's reduction of the same payloads (its
    float64 rows stacked in rank order and reduced along axis 0)."""
    script = tmp_path / "prog.py"
    script.write_text(_TWO_RANK)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(launcher.__file__)))
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    coordinator = f"localhost:{launcher.free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path)],
        env=launcher.make_env(r, 2, coordinator, env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
        assert f"RANK {r} OK" in o
    ins = [np.load(tmp_path / f"in{r}.npy") for r in range(2)]
    stack = np.stack([np.atleast_1d(np.asarray(v, np.float64))
                      for v in ins])
    want = {"sum": stack.sum(axis=0), "max": stack.max(axis=0),
            "mean": np.stack([[1.0], [2.0]]).mean(axis=0),
            "bc": np.arange(5, dtype=np.int64) * 8}
    for name, w in want.items():
        for r in range(2):
            got = np.load(tmp_path / f"{name}{r}.npy")
            assert got.dtype == w.dtype and got.shape == w.shape
            assert got.tobytes() == w.tobytes(), (name, r)
