"""RPC between training workers (counterpart of
paddle_tpu/distributed/rpc/rpc.py:34-381; the reference's init_rpc:73,
rpc_sync:141, rpc_async:179, barrier and store :38-71).

The control plane stays on the host: a pure-Python implementation over
``multiprocessing.connection``. Rank 0 runs a registry ``Listener`` (the
reference's master store), and each worker serves calls on its own
``Listener`` in a daemon thread. It works on one host and across hosts
(TCP), authenticated by a shared key: ``PADDLE_RPC_AUTHKEY``, or on the
loopback a random key rank 0 writes to a user-only file in the system's
temporary directory.
"""
from __future__ import annotations

import os
import threading
import time
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from multiprocessing.connection import Client, Listener
from typing import Any, Dict, List, Optional

WorkerInfo = namedtuple("WorkerInfo", ["name", "rank", "ip", "port"])

_DEFAULT_RPC_TIMEOUT = 30.0

_state: Dict[str, Any] = {
    "inited": False, "name": None, "rank": None, "world_size": None,
    "workers": {}, "service": None, "master": None, "authkey": None,
    "pool": None,
}


def _auth(master_endpoint: str, rank: int = 0) -> bytes:
    """Connection authkey. The service EXECUTES PICKLED CALLABLES, so the
    key must never be derivable from the (public) endpoint — on a shared
    host any local user can reach 127.0.0.1:<port>. Cross-host: set
    PADDLE_RPC_AUTHKEY to the same random value on every worker (the
    launcher does this for spawned jobs). Loopback without the env var:
    rank 0 generates a random secret and shares it through a user-only
    (0600) keyfile — same user, same trust boundary."""
    secret = os.environ.get("PADDLE_RPC_AUTHKEY")
    if secret:
        return secret.encode()
    host = master_endpoint.rsplit(":", 1)[0]
    if host not in ("127.0.0.1", "localhost", "::1"):
        raise RuntimeError(
            "cross-host rpc needs PADDLE_RPC_AUTHKEY set (a shared "
            "random secret): an endpoint-derived key would let any host "
            "that can reach the service port execute code in the "
            "trainer process")
    import hashlib
    import secrets
    import tempfile
    tag = hashlib.sha256(master_endpoint.encode()).hexdigest()[:16]
    path = os.path.join(tempfile.gettempdir(),
                        f"paddle_rpc_{os.getuid()}_{tag}.key")
    if rank == 0:
        key = secrets.token_bytes(32)
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        except PermissionError:
            raise RuntimeError(
                f"rpc keyfile {path} exists and belongs to another user — "
                "refusing the shared-tempdir key; set PADDLE_RPC_AUTHKEY")
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        except FileExistsError:
            raise RuntimeError(
                f"rpc keyfile {path} reappeared (another process owns "
                "it); set PADDLE_RPC_AUTHKEY for this job")
        with os.fdopen(fd, "wb") as f:
            f.write(key)
        _state["keyfile"] = path
        return key
    deadline = time.time() + _DEFAULT_RPC_TIMEOUT
    while True:
        try:
            st = os.stat(path)
            if st.st_uid != os.getuid():
                raise RuntimeError(
                    f"rpc keyfile {path} owned by another user — refusing "
                    "the shared-tempdir key; set PADDLE_RPC_AUTHKEY")
            with open(path, "rb") as f:
                key = f.read()
            if len(key) == 32:
                return key
        except FileNotFoundError:
            pass
        if time.time() > deadline:
            raise TimeoutError(
                f"init_rpc: rank 0 never published the rpc keyfile {path}")
        time.sleep(0.05)


class _MasterRegistry(threading.Thread):
    """Rank-0 registry: collects WorkerInfos, hands the full table to each
    worker once all ranks registered (the reference's barrier store)."""

    def __init__(self, endpoint, world_size, authkey):
        super().__init__(daemon=True)
        ip, port = endpoint.rsplit(":", 1)
        self._listener = Listener((ip, int(port)), authkey=authkey)
        self._world = world_size
        self._infos: Dict[int, WorkerInfo] = {}
        self._cv = threading.Condition()
        self._stop = False
        self._barrier_count = 0

    def run(self):
        from multiprocessing import AuthenticationError
        while not self._stop:
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                # a peer dialed in with a wrong/stale key — drop THAT
                # connection, keep serving (the peer re-reads the keyfile
                # and retries; dying here would hang every rank)
                continue
            except (OSError, EOFError):
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            msg = conn.recv()
            if msg[0] == "register":
                info = WorkerInfo(*msg[1])
                with self._cv:
                    self._infos[info.rank] = info
                    self._cv.notify_all()
                    self._cv.wait_for(
                        lambda: len(self._infos) >= self._world
                        or self._stop)
                conn.send(sorted(self._infos.values(),
                                 key=lambda w: w.rank))
            elif msg[0] == "barrier":
                # shutdown barrier (the reference's barrier store): no
                # worker tears its service down before every worker is
                # done issuing RPCs
                with self._cv:
                    self._barrier_count += 1
                    self._cv.notify_all()
                    self._cv.wait_for(
                        lambda: self._barrier_count >= self._world
                        or self._stop)
                conn.send("go")
            elif msg[0] == "stop":
                self.stop()
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass


class _Service(threading.Thread):
    """Per-worker request server: recv (fn, args, kwargs) → run → reply."""

    def __init__(self, authkey, bind_ip="127.0.0.1"):
        super().__init__(daemon=True)
        self._listener = Listener((bind_ip, 0), authkey=authkey)
        self.port = self._listener.address[1]
        self._stop = False

    def run(self):
        from multiprocessing import AuthenticationError
        while not self._stop:
            try:
                conn = self._listener.accept()
            except AuthenticationError:
                # a peer dialed in with a wrong/stale key — drop THAT
                # connection, keep serving (the peer re-reads the keyfile
                # and retries; dying here would hang every rank)
                continue
            except (OSError, EOFError):
                break
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            fn, args, kwargs = conn.recv()
            try:
                result = fn(*args, **kwargs)
                conn.send(("ok", result))
            except Exception as e:  # ship the failure to the caller
                conn.send(("err", e))
        except (EOFError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None):
    """The reference's rpc.py:73: start this worker's service and rendezvous through
    the master registry. rank/world_size/master_endpoint fall back to
    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER_ENDPOINT."""
    if _state["inited"]:
        raise RuntimeError("init_rpc called twice")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", -1)) \
        if rank is None else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", -1)) \
        if world_size is None else world_size
    master_endpoint = os.environ.get("PADDLE_MASTER_ENDPOINT",
                                     master_endpoint) \
        if master_endpoint is None else master_endpoint
    if rank < 0 or world_size <= 0 or not master_endpoint:
        raise ValueError("init_rpc needs name, rank, world_size and "
                         "master_endpoint (args or PADDLE_* env)")
    authkey = _auth(master_endpoint, rank)

    master = None
    if rank == 0:
        master = _MasterRegistry(master_endpoint, world_size, authkey)
        master.start()

    # cross-host: when the master is not loopback, advertise the IP this
    # host uses to reach it (overridable with PADDLE_LOCAL_IP) and bind
    # the service on all interfaces so peers can dial in
    mhost = master_endpoint.rsplit(":", 1)[0]
    loopback = mhost in ("127.0.0.1", "localhost", "::1")
    my_ip = os.environ.get("PADDLE_LOCAL_IP")
    if my_ip is None:
        if loopback:
            my_ip = "127.0.0.1"
        else:
            import socket
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.connect((mhost, 1))
                my_ip = s.getsockname()[0]
    service = _Service(authkey,
                       bind_ip="127.0.0.1" if loopback else "0.0.0.0")
    service.start()
    info = (name, rank, my_ip, service.port)

    # register with the master (retry while rank 0 comes up)
    from multiprocessing import AuthenticationError
    mhost, mport = master_endpoint.rsplit(":", 1)
    deadline = time.time() + _DEFAULT_RPC_TIMEOUT
    workers: List[WorkerInfo] = []
    while True:
        try:
            conn = Client((mhost, int(mport)), authkey=authkey)
            conn.send(("register", info))
            workers = conn.recv()
            conn.close()
            break
        except AuthenticationError:
            # a stale keyfile from a previous job: rank 0 republishes on
            # startup, so re-read the key and restart our service with it
            if time.time() > deadline:
                service.stop()
                raise TimeoutError(
                    f"init_rpc: authentication with master "
                    f"{master_endpoint} kept failing (stale key?)")
            time.sleep(0.1)
            new_key = _auth(master_endpoint, rank)
            if new_key != authkey:
                authkey = new_key
                service.stop()
                service = _Service(
                    authkey,
                    bind_ip="127.0.0.1" if loopback else "0.0.0.0")
                service.start()
                info = (name, rank, my_ip, service.port)
        except (ConnectionError, OSError):
            if time.time() > deadline:
                service.stop()
                raise TimeoutError(
                    f"init_rpc: cannot reach master {master_endpoint}")
            time.sleep(0.05)

    _state.update(inited=True, name=name, rank=rank,
                  world_size=world_size, service=service, master=master,
                  authkey=authkey, master_endpoint=master_endpoint,
                  workers={w.name: w for w in workers},
                  pool=ThreadPoolExecutor(max_workers=8))


def _require_init():
    if not _state["inited"]:
        raise RuntimeError("call paddle.distributed.rpc.init_rpc first")


def rpc_sync(to: str, fn, args=None, kwargs=None,
             timeout=_DEFAULT_RPC_TIMEOUT):
    """The reference's rpc.py:141: run fn(*args, **kwargs) on worker `to`, return the
    result (raises the remote exception locally)."""
    _require_init()
    w = _state["workers"].get(to)
    if w is None:
        raise ValueError(f"unknown rpc worker {to!r}; known: "
                         f"{sorted(_state['workers'])}")
    conn = Client((w.ip, w.port), authkey=_state["authkey"])
    try:
        conn.send((fn, tuple(args or ()), dict(kwargs or {})))
        if timeout and timeout > 0 and not conn.poll(timeout):
            raise TimeoutError(f"rpc to {to!r} timed out after {timeout}s")
        status, payload = conn.recv()
    finally:
        conn.close()
    if status == "err":
        raise payload
    return payload


def rpc_async(to: str, fn, args=None, kwargs=None,
              timeout=_DEFAULT_RPC_TIMEOUT):
    """The reference's rpc.py:179: returns a future with wait()/result()."""
    _require_init()
    fut = _state["pool"].submit(rpc_sync, to, fn, args, kwargs, timeout)
    fut.wait = fut.result  # paddle's FutureWrapper API
    return fut


def get_worker_info(name: str) -> WorkerInfo:
    _require_init()
    return _state["workers"][name]


def get_all_worker_infos() -> List[WorkerInfo]:
    _require_init()
    return sorted(_state["workers"].values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    _require_init()
    return _state["workers"][_state["name"]]


def shutdown():
    """The reference's shutdown: barrier across workers (nobody stops serving
    while a peer may still call in), then stop the service (and the
    registry on rank 0)."""
    if not _state["inited"]:
        return
    if _state["pool"] is not None:
        _state["pool"].shutdown(wait=True)
    if _state["world_size"] > 1:
        mhost, mport = _state["master_endpoint"].rsplit(":", 1)
        try:
            conn = Client((mhost, int(mport)), authkey=_state["authkey"])
            conn.send(("barrier",))
            conn.recv()
            conn.close()
        except (ConnectionError, OSError, EOFError):
            pass  # master already gone: best effort
    if _state["service"] is not None:
        _state["service"].stop()
    if _state["master"] is not None:
        _state["master"].stop()
        keyfile = _state.get("keyfile")
        if keyfile:                     # rank 0: retire the job's keyfile
            try:
                os.remove(keyfile)
            except OSError:
                pass
    _state.update(inited=False, name=None, rank=None, world_size=None,
                  workers={}, service=None, master=None, authkey=None,
                  pool=None)
