"""The launcher (counterpart of paddle_tpu/distributed/launch/
main.py:21-83): ``python -m paddle_tpu_torch.distributed.launch
[--nproc_per_node N] [--master ip:port] [--timeout S] script.py
[args]``.

With ``--nproc_per_node`` above 1 it spawns the node's ranks, one
process each, with the environment ``init_parallel_env`` reads:
``PADDLE_MASTER`` (``--master``, else a free port on 127.0.0.1),
``MASTER_ADDR`` / ``MASTER_PORT``, ``PADDLE_TRAINERS_NUM`` (nnodes x
nproc_per_node) and ``PADDLE_TRAINER_ID`` (node rank x nproc_per_node +
the local rank), and ``PYTHONPATH`` leading to this package. It waits for them: a rank that exits non-zero stops
the others and its code is the launcher's; past ``--timeout`` seconds
every rank is killed and the launcher exits 124. Under
``--elastic_level`` >= 1 the ranks run under ``ElasticSupervisor``
instead, which relaunches the pod when one dies. With one process per
node the script runs in this process, as the reference runs it.
"""
from __future__ import annotations

import argparse
import os
import runpy
import socket
import subprocess
import sys
import time


def _parse(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=None,
                   help="master endpoint ip:port of the rendezvous")
    p.add_argument("--nnodes", default="1")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_TRAINER_ID", "0")),
                   help="this node's rank")
    p.add_argument("--nproc_per_node", type=int, default=None)
    p.add_argument("--devices", "--gpus", "--xpus", default=None,
                   help="card ids to use, e.g. 0,1,2,3")
    p.add_argument("--job_id", default="default")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--run_mode", default="collective")
    p.add_argument("--server_num", default=None)
    p.add_argument("--trainer_num", default=None)
    p.add_argument("--elastic_level", type=int, default=-1)
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds the ranks may run before all are killed")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_envs(args, nnodes, nproc):
    master = args.master or f"127.0.0.1:{_free_port()}"
    host, port = master.rsplit(":", 1)
    # the ranks import the package from where this launcher did
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    path = os.pathsep.join(p for p in (
        root, os.environ.get("PYTHONPATH")) if p)
    envs = []
    for r in range(nproc):
        env = dict(os.environ, PYTHONPATH=path)
        env.update(PADDLE_MASTER=master, MASTER_ADDR=host, MASTER_PORT=port,
                   PADDLE_TRAINERS_NUM=str(nnodes * nproc),
                   PADDLE_TRAINER_ID=str(args.rank * nproc + r),
                   PADDLE_LOCAL_RANK=str(r))
        envs.append(env)
    return envs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def run_ranks(cmds, envs, timeout=None, poll=0.05) -> int:
    """Run one process per command; 0 when every one exits 0, else the
    first non-zero code (the others killed), 124 past ``timeout``."""
    procs = [subprocess.Popen(c, env=e) for c, e in zip(cmds, envs)]
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if timeout is not None and time.monotonic() - t0 > timeout:
                print(f"launch: ranks still running after {timeout} s, "
                      f"killed", file=sys.stderr, flush=True)
                return 124
            time.sleep(poll)
    finally:
        _stop(procs)


def launch(*, argv=None) -> int:
    args = _parse(argv)
    nnodes = int(str(args.nnodes).split(":")[0])
    nproc = args.nproc_per_node or 1
    if args.devices:
        os.environ["CUDA_VISIBLE_DEVICES"] = args.devices
    if nproc > 1:
        envs = _rank_envs(args, nnodes, nproc)
        cmds = [[sys.executable, args.script] + args.script_args
                for _ in range(nproc)]
        if args.elastic_level >= 1:
            # supervisor mode (the reference's ElasticManager relaunch)
            from ..fleet.elastic import ElasticSupervisor
            return ElasticSupervisor(cmds, envs).run()
        return run_ranks(cmds, envs, args.timeout)
    os.environ.setdefault("PADDLE_TRAINER_ID", str(args.rank))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(nnodes))
    if args.master:
        os.environ["PADDLE_MASTER"] = args.master
        host, port = args.master.rsplit(":", 1)
        os.environ.setdefault("MASTER_ADDR", host)
        os.environ.setdefault("MASTER_PORT", port)
    sys.argv = [args.script] + args.script_args
    runpy.run_path(args.script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(launch())
