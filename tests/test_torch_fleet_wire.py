"""The fleet's process and wire boundaries in the port: a spawned
worker's imports, the spec builder's default device, a seeded network
storm through both packages' session layers (equal replies, executions
and ``net.*`` counters), and the socket clients' receive time for large
frames."""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.inference as J
import paddle_tpu_torch.inference as P
from paddle_tpu.inference import net as j_net
from paddle_tpu_torch.inference import net as p_net
from paddle_tpu_torch.inference import router as p_router
from paddle_tpu_torch.inference.recovery import (FRAME_HEADER_SIZE,
                                                 frame_body_size,
                                                 frame_message,
                                                 unframe_message)
from tests.torch_twins import shared_jax_cache  # noqa: F401

BASE = dict(head_roll=1, block_size=4, num_blocks=80,
            max_blocks_per_seq=10)


def _spec(root, name):
    return dict(BASE, journal_path=os.path.join(root, f"{name}.wal"),
                snapshot_path=os.path.join(root, f"{name}.ckpt"))


def test_spec_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_router.build_model_from_spec(BASE)


def test_spawned_child_imports_no_jax(tmp_path):
    """What a spawned worker imports to build its server (the pipe and
    socket children's entry modules, then ``build_server_from_spec``)
    pulls in torch and never JAX or the JAX package."""
    code = (
        "import sys\n"
        "from paddle_tpu_torch.inference import fleet, router\n"
        f"srv = router.build_server_from_spec({_spec(str(tmp_path), 'c')!r}"
        " | {'device': 'cpu'})\n"
        "srv.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert 'torch' in sys.modules and not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


class _Echo:
    """A stand-in worker recording every execution."""

    def __init__(self):
        self.calls = []

    def handle(self, op, payload):
        self.calls.append((op, payload.get("x")))
        return {"op": op, "x": payload.get("x"), "n": len(self.calls)}


def _net_storm(pkg, seed, n_ops=24):
    """``n_ops`` ops through one session of ``pkg``'s SocketHost and
    ResilientTransport under a seeded NetworkFaultInjector storm."""
    mod, net = {"jax": (J, j_net), "port": (P, p_net)}[pkg]
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    peer = ("127.0.0.1", lsock.getsockname()[1])
    csock = socket.create_connection(peer)
    conn, _ = lsock.accept()
    worker = _Echo()
    host = net.SocketHost(lsock, worker, conn=conn, accept_timeout=30.0)
    th = threading.Thread(target=host.serve, daemon=True)
    th.start()
    inj = mod.NetworkFaultInjector.storm(seed, ["s"], span=(2, n_ops))
    t = net.ResilientTransport(csock, name="s", peer=peer, timeout=0.3,
                               probe_timeout=2.0, max_retries=3,
                               injector=inj)
    t.hello()
    try:
        replies = [t.call("op", {"x": i}) for i in range(n_ops)]
        t.call("close")
    finally:
        t.close()
        th.join(timeout=10)
        lsock.close()
    assert not th.is_alive()
    return dict(replies=replies, net=t.net_stats(), fired=inj.fired,
                calls=worker.calls, accepts=host.accepts)


@pytest.mark.parametrize("seed", [11, 12])
def test_network_storm_counters_are_equal(seed):
    """Every reply arrives once and every op executes once in both
    packages, with equal net.* counters and injector tallies."""
    j, p = _net_storm("jax", seed), _net_storm("port", seed)
    assert p == j
    assert [r["x"] for r in p["replies"]] == list(range(24))
    assert p["net"]["reconnects"] >= 1 and sum(p["fired"].values()) == 6


def _send(sock, data):
    """A writer thread's body: the reader may give up and close first."""
    try:
        sock.sendall(data)
    except OSError:
        pass


def _big_frame_reader(make_reader, read):
    """Seconds ``read(reader)`` takes to receive one 64 MiB framed reply
    (seq 1) that a thread writes into the reader's socket."""
    a, b = socket.socketpair()
    payload = np.arange(16 << 20, dtype=np.float32)
    frame = frame_message({"_seq": 1, "a": payload})
    reader = make_reader(b)
    th = threading.Thread(target=_send, args=(a, frame), daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        msg = read(reader)
        secs = time.perf_counter() - t0
    finally:
        th.join(timeout=60)
        a.close()
        b.close()
    np.testing.assert_array_equal(msg["a"], payload)
    return secs


def _slow_peer(sock, delay=0.5):
    """A peer that is busy for ``delay`` s, then reads one framed op
    and answers it with the size of its array."""
    def run():
        time.sleep(delay)
        try:
            head = p_net.read_exact(sock, FRAME_HEADER_SIZE)
            body = p_net.read_exact(sock, frame_body_size(head))
            seq, _op, payload = unframe_message(head, body)
            sock.sendall(frame_message({"_seq": seq,
                                        "n": int(payload["a"].size)}))
        except OSError:
            pass                  # the client gave up and closed
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _refused_peer():
    """(host, port) where nothing listens."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    peer = s.getsockname()
    s.close()
    return peer


def test_socket_clients_move_large_frames(tmp_path):
    """A full-width page slice is ~10^8 bytes. Both socket clients
    buffer a reply in a bytearray, so a 64 MiB frame arrives in well
    under 5 s (the reference's bytes concatenation copies the whole
    buffer per 64 KiB chunk: tens of seconds for 64 MiB),
    and the raw client's send of a 16 MiB frame waits for a peer busy
    for 0.5 s within the op's timeout (ROADMAP Queue C item 11)."""
    secs = _big_frame_reader(
        lambda s: p_net.ResilientTransport(s, name="big",
                                           peer=("127.0.0.1", 9)),
        lambda t: t._await(1, 60.0))
    assert secs < 5.0, secs
    w = P.SocketWorker(dict(_spec(str(tmp_path), "raw"), device="cpu"),
                       name="raw", resilient=False, timeout=120.0)
    try:
        sock, seq = w._sock, w._seq

        def read(s):
            w._sock = s
            return w._recv(60.0, want_seq=1)
        secs = _big_frame_reader(lambda s: s, read)
        assert secs < 5.0, secs
        a, b = socket.socketpair()
        b.settimeout(0.05)        # what the last reply's poll leaves
        w._sock, w._seq = b, 0
        th = _slow_peer(a)
        assert w.request("big", {"a": np.zeros(4 << 20, np.float32)},
                         timeout=30.0) == {"n": 4 << 20}
        th.join(timeout=10)
        a.close()
        b.close()
        w._sock, w._seq = sock, seq
        assert w.request("ping") == {}
    finally:
        w.kill()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_large_send_outlasts_the_last_polls_timeout(pkg):
    """The session client sends a 16 MiB op (past the socket buffers)
    to a peer busy for 0.5 s, on a socket whose timeout the previous
    reply's last poll left at 50 ms. The port gives the send the op's
    timeout and gets the answer; the JAX package's sendall times out,
    reads the drop as a wire fault and its probe finds no listener
    (at full width every slice import failed so; ROADMAP Queue C item
    11)."""
    net = {"jax": j_net, "port": p_net}[pkg]
    a, b = socket.socketpair()
    b.settimeout(0.05)
    t = net.ResilientTransport(b, name=f"send-{pkg}", peer=_refused_peer(),
                               timeout=30.0, probe_timeout=1.0,
                               max_retries=1, backoff_cap=1)
    th = _slow_peer(a)
    big = {"a": np.zeros(4 << 20, np.float32)}
    try:
        if pkg == "jax":
            with pytest.raises((J.WorkerDied, J.WorkerTimeout)):
                t.call("big", big)
        else:
            assert t.call("big", big) == {"n": 4 << 20}
    finally:
        t.close()
        a.close()
        th.join(timeout=10)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_reply_longer_than_the_poll_budget_still_arrives(pkg):
    """A 0.5 s op budget is 10 polls of 50 ms; a 4 MiB reply streams in
    far more 64 KiB polls than that. The port's session client spends
    budget only on polls that time out, so the reply arrives; the JAX
    package's counts every poll and gives up with the bytes still
    flowing (at its 120 s default a reply caps at 157 MB, below one
    full-width page slice; ROADMAP Queue C item 11)."""
    net = {"jax": j_net, "port": p_net}[pkg]
    a, b = socket.socketpair()
    payload = np.arange(1 << 20, dtype=np.float32)
    th = threading.Thread(target=_send, args=(a, frame_message(
        {"_seq": 1, "a": payload})), daemon=True)
    t = net.ResilientTransport(b, name="budget", peer=("127.0.0.1", 9))
    th.start()
    try:
        if pkg == "jax":
            with pytest.raises(Exception, match="no answer in 0.5s"):
                t._await(1, 0.5)
        else:
            np.testing.assert_array_equal(t._await(1, 0.5)["a"], payload)
    finally:
        b.close()
        th.join(timeout=10)
        a.close()
