"""The port's chain read path (``repro_torch.serve``: ``ChainReadServer``
and the header-only ``LightClient``) against the JAX package's
(``repro.serve``), and the port's checkpoints (``repro_torch.checkpoint``)
against ``repro.checkpoint``.

Both read paths serve chain-only contracts settled from the same seeded
scores. Blocks and cids are never compared across packages; what must
agree is what a client sees: the decoded records, the number of shared
siblings a batch ships, each verification's verdict (a tampered batch is
rejected, never raised on), the errors raised, and the streamed leaves.

Checkpoints: a round trip restores every leaf bit for bit (bf16 goes
through f32 data, exactly), in ``like``'s structure, dtype and device; the
two packages read each other's files (the blob layout is shared: leaf 0
is the step, then the tree's leaves in sorted-key order).
"""
import hashlib
import threading

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.chain.contract import TrustContract as JContract
from repro.chain.ipfs import IPFSStore as JStore
from repro.chain.ledger import Ledger as JLedger
from repro.chain.proofs import ROOT_KEY as JROOT_KEY
from repro_torch import serve
from repro_torch.chain.contract import TrustContract
from repro_torch.chain.ipfs import IPFSStore
from repro_torch.chain.ledger import Ledger
from repro_torch.chain.proofs import ROOT_KEY, verify_proof_batch
from repro_torch.checkpoint import store

PORT = dict(serve=serve, Contract=TrustContract, Ledger=Ledger,
            Store=IPFSStore, root_key=ROOT_KEY)
REF = dict(serve=jserve, Contract=JContract, Ledger=JLedger, Store=JStore,
           root_key=JROOT_KEY)


def _contract(pkg, W, *, sparse=False, shards=1, chunk=8):
    c = pkg["Contract"](pkg["Ledger"](), requester_deposit=1e6,
                        worker_stake=10.0, penalty_pct=50.0,
                        trust_threshold=0.5, top_k=max(W // 4, 1),
                        merkle_chunk_size=chunk, sparse_settlement=sparse,
                        settlement_shards=shards)
    c.join_batch(W)
    return c


def _settle(c, rounds=2, seed=0, cohort=None):
    rng = np.random.default_rng(seed)
    W = c.num_workers
    for r in range(rounds):
        if cohort:
            ids = np.sort(rng.choice(W, cohort, replace=False)).astype(
                np.int64)
            c.settle_round_batch(r, rng.random(cohort), worker_ids=ids,
                                 timestamp=float(r + 1))
        else:
            c.settle_round_batch(r, rng.random(W), timestamp=float(r + 1))
    return c


FLAVORS = {"dense": dict(), "sharded": dict(shards=4),
           "delta": dict(sparse=True, cohort=16),
           "wide-chunk": dict(chunk=64, shards=2)}


def _flavor(pkg, name):
    kw = dict(FLAVORS[name])
    cohort = kw.pop("cohort", None)
    return _settle(_contract(pkg, 64, **kw), cohort=cohort)


# -- proofs ---------------------------------------------------------------------


@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_batched_proofs_match_reference(flavor):
    wids = [0, 5, 9, 33, 40, 63]
    out = []
    for pkg in (PORT, REF):
        c = _flavor(pkg, flavor)
        srv = pkg["serve"].ChainReadServer(contracts=c)
        lc = pkg["serve"].LightClient(srv)
        gained = lc.sync()
        batch = lc.fetch_proofs(None, wids, round_index=1)
        out.append((gained, srv.latest_settled_round(None), len(batch),
                    batch.num_digests, lc.verify_batch(batch),
                    [batch.decoded(i) for i in range(len(batch))],
                    lc.audit(None, 9, round_index=0)))
    assert out[0] == out[1]
    assert out[0][4] is True


TAMPERS = ["chunk", "sibling", "offset", "foreign-key", "plan", "root",
           "root-override", "stored-record"]


def _tampered(pkg, kind):
    from repro.chain.proofs import build_proof_batch as jbuild
    from repro_torch.chain.proofs import build_proof_batch as build
    c = _settle(_contract(pkg, 64, shards=4))
    blk = c.ledger.blocks[c._round_blocks[1]]
    b = (build if pkg is PORT else jbuild)(c.ledger, blk.index,
                                           [0, 9, 33, 63])
    key = next(iter(b.chunks))
    ri, rkey, _ = b.records[0]
    if kind == "chunk":
        raw = bytearray(b.chunks[key])
        raw[5] ^= 1
        b.chunks[key] = bytes(raw)
    elif kind == "sibling":
        skey = sorted(b.siblings)[0]
        flipped = bytearray(bytes.fromhex(b.siblings[skey]))
        flipped[0] ^= 1
        b.siblings[skey] = flipped.hex()
    elif kind == "offset":
        b.records[0] = (ri, rkey, 10_000)
    elif kind == "foreign-key":
        b.chunks[("S", 99, 0, 0)] = b.chunks[rkey]
        b.records[0] = (ri, ("S", 99, 0, 0), 0)
    elif kind == "plan":
        b.plan = b.plan[:-1]
    elif kind == "root":
        b.root = "cd" * 32
    elif kind == "root-override":
        b.siblings[pkg["root_key"]] = blk.records_root
    elif kind == "stored-record":
        c.ledger.tamper_record(blk.index, 9, b"\x00" * 48)
        b = (build if pkg is PORT else jbuild)(c.ledger, blk.index, [9])
    return b, blk


@pytest.mark.parametrize("kind", TAMPERS)
def test_tampered_batches_rejected_like_reference(kind):
    from repro.chain.proofs import verify_proof_batch as jverify
    got = verify_proof_batch(*_tampered(PORT, kind))
    want = jverify(*_tampered(REF, kind))
    assert got is False and want is False


def test_head_sync_and_stale_proofs_match_reference():
    out = []
    for pkg in (PORT, REF):
        s = pkg["serve"]
        c = _settle(_contract(pkg, 64), rounds=3)
        srv = s.ChainReadServer(contracts=c)
        lc = s.LightClient(srv)
        trace = [lc.sync(), lc.sync()]
        reply = srv.sync_head(lc.height, lc.headers[-1].hash)
        trace.append((reply.current, len(reply.headers), reply.reset))
        c.settle_round_batch(3, np.random.default_rng(5).random(64),
                             timestamp=5.0)
        batch = lc.fetch_proofs(None, [4, 40], round_index=3)
        with pytest.raises(s.StaleProofError):
            lc.verify_batch(batch)
        trace += [lc.sync(), lc.verify_batch(batch),
                  lc.audit(None, 4, round_index=3)]
        reply = srv.sync_head(2, "ff" * 32)
        trace.append((reply.reset, len(reply.headers), srv.head_resets))
        out.append(trace)
    assert out[0] == out[1]


@pytest.mark.parametrize("attr", ["hash", "prev_hash", "index",
                                  "records_root"])
def test_corrupt_headers_rejected(attr):
    from repro_torch.chain.proofs import BlockHeader
    c = _settle(_contract(PORT, 64), rounds=3)
    srv = serve.ChainReadServer(contracts=c)
    lc = serve.LightClient(srv)
    lc.sync()
    h = lc.headers[1]
    bad = list(lc.headers)
    bad[1] = BlockHeader(**{**h.__dict__, attr: 40 if attr == "index"
                            else "d" * 64})
    victim = serve.LightClient(srv)
    with pytest.raises(serve.HeaderVerificationError):
        victim._verify_and_adopt(bad, [])
    assert victim.headers == []


def test_server_errors_match_reference():
    seen = []
    for pkg in (PORT, REF):
        s = pkg["serve"]
        c = _settle(_contract(pkg, 64), rounds=3)
        srv = s.ChainReadServer(contracts=c, max_batch=8)
        errs = []
        for call in (lambda: srv.get_proofs(None, [0], round_index=77),
                     lambda: srv.get_proofs(None, list(range(9)))):
            with pytest.raises(Exception) as e:
                call()
            errs.append(type(e.value).__name__)
        cs = _contract(pkg, 64)
        ids = np.array([40, 3, 17, 9, 55, 21, 0, 33], np.int64)
        cs.settle_round_batch(0, np.random.default_rng(3).random(len(ids)),
                              worker_ids=ids, timestamp=1.0)
        lc2 = s.LightClient(s.ChainReadServer(contracts=cs))
        recs = [lc2.audit(None, w, round_index=0) for w in (40, 0, 33)]
        with pytest.raises(KeyError):
            lc2.fetch_proofs(None, [1], round_index=0)
        cd = _settle(_contract(pkg, 64, sparse=True), rounds=1, cohort=8)
        idle = next(w for w in range(64)
                    if w not in set(cd._round_ids[0].tolist()))
        recs.append(s.LightClient(s.ChainReadServer(contracts=cd)).audit(
            None, idle, round_index=0))
        seen.append((errs, recs))
    assert seen[0] == seen[1]
    assert seen[0][0] == ["RoundNotSettled", "ValueError"]


def test_checkpoint_streaming_and_quota_match_reference():
    tree = {"w": np.arange(4096, dtype=np.float32),
            "b": np.ones(7, np.float32)}
    noise = {"x": np.random.default_rng(0).random(500).astype(np.float32)}
    for pkg in (PORT, REF):
        s = pkg["serve"]
        c = _settle(_contract(pkg, 16), rounds=1)
        ipfs = pkg["Store"]()
        cid = ipfs.put_tree(tree, owner="t")
        srv = s.ChainReadServer(contracts=c, ipfs=ipfs, chunk_bytes=512)
        leaves = s.LightClient(srv, client_id="aud").fetch_checkpoint(cid)
        for got, want in zip(leaves, (tree["b"], tree["w"])):
            np.testing.assert_array_equal(np.asarray(got), want)
        man = srv.checkpoint_manifest(cid)
        assert man.num_chunks == -(-man.size // 512) == srv.chunks_streamed
        assert hashlib.sha256(b"".join(
            srv.checkpoint_chunk(cid, i)
            for i in range(man.num_chunks))).hexdigest() == cid
        with pytest.raises(IndexError):
            srv.checkpoint_chunk(cid, man.num_chunks)
        ipfs.tamper(cid, b"z" * man.size)
        with pytest.raises(ValueError, match="content hash"):
            s.LightClient(srv).fetch_checkpoint(cid)
        srv2 = s.ChainReadServer(contracts=c, ipfs=pkg["Store"](),
                                 chunk_bytes=64, serve_quota_bytes=128)
        cid2 = srv2.ipfs.put_tree(noise)
        with pytest.raises(s.QuotaExceeded):
            s.LightClient(srv2, client_id="greedy").fetch_checkpoint(cid2)
        assert s.LightClient(srv2).fetch_checkpoint(cid2)


def test_node_read_server_audits_a_multi_task_node():
    from repro_torch.configs.base import FederationConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.node import ChainNode
    from repro_torch.data.datasets import make_federated_mnist
    node = ChainNode(pipeline_depth=2, device="cpu")
    tc = TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd")
    for i, (tid, W) in enumerate((("a", 2), ("b", 3))):
        node.create_task(tid, get_config("paper-net"),
                         FederationConfig(num_clusters=1,
                                          workers_per_cluster=W,
                                          trust_threshold=0.2,
                                          merkle_chunk_size=2, task_id=tid),
                         tc, seed=i)
    ds = {t: make_federated_mnist(node.tasks[t].W, samples=64, seed=1)
          for t in node.tasks}
    for tick in range(3):
        node.run_tick({t: d.round_batches(8) for t, d in ds.items()
                       if tick != 1 or t == "a"})
    node.flush()
    lc = serve.LightClient(node.read_server())
    assert lc.sync() == len(node.ledger.blocks)
    batch = lc.fetch_proofs("b", [0, 1, 2], round_index=1)
    assert lc.verify_batch(batch)
    assert [batch.decoded(i)["worker"] for i in range(3)] == [0, 1, 2]
    assert lc.audit("a", 1)["round"] == 2
    with pytest.raises(ValueError):
        lc.fetch_proofs(None, [0])                 # two tasks: name one
    node.finalize()


def test_concurrent_readers_never_see_torn_state():
    W, rounds = 1_000, 8
    c = _contract(PORT, W, chunk=64)
    srv = serve.ChainReadServer(contracts=c)
    c.settle_round_batch(0, np.random.default_rng(0).random(W),
                         timestamp=1.0)
    stop = threading.Event()
    failures = []

    def writer():
        rng = np.random.default_rng(1)
        for r in range(1, rounds):
            c.settle_round_batch(r, rng.random(W), timestamp=float(r + 1))
        stop.set()

    def reader(i):
        lc = serve.LightClient(srv)
        rng = np.random.default_rng((2, i))
        try:
            while not stop.is_set() or lc.height < srv.height:
                lc.sync()
                r = srv.latest_settled_round(None)
                batch = srv.get_proofs(None, rng.integers(0, W, size=32),
                                       round_index=r)
                try:
                    ok = lc.verify_batch(batch)
                except serve.StaleProofError:
                    lc.sync()
                    ok = lc.verify_batch(batch)
                if not ok:
                    failures.append((i, r))
                    return
        except Exception as e:                     # pragma: no cover
            failures.append((i, repr(e)))

    threads = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not failures and srv.proofs_served > 0


# -- checkpoints ----------------------------------------------------------------


def _tree(dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 7), generator=gen)
    return {"params": {"w": x.to(dtype), "b": torch.arange(3).to(dtype)},
            "opt": {"count": torch.tensor(4, dtype=torch.int64)},
            "host": np.linspace(0, 1, 6, dtype=np.float32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32])
def test_checkpoint_round_trip(tmp_path, dtype):
    tree = _tree(dtype)
    led = Ledger()
    path = str(tmp_path / "ckpt" / "t.msgpack")
    cid = store.save(path, tree, step=12, ledger=led)
    assert store.verify(path, cid)
    assert led.head.transactions[0] == {"type": "checkpoint", "step": 12,
                                        "cid": cid}
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": {"count": torch.tensor(0)}, "host": np.zeros(6, np.float32)}
    got, step = store.restore(path, like)
    assert step == 12
    assert list(got) == sorted(like) and list(got["params"]) == ["b", "w"]
    for k, v in tree["params"].items():
        assert got["params"][k].dtype == dtype
        assert torch.equal(got["params"][k], v)
    assert torch.equal(got["opt"]["count"], tree["opt"]["count"])
    assert isinstance(got["host"], np.ndarray)
    np.testing.assert_array_equal(got["host"], tree["host"])
    with open(path, "r+b") as f:                     # flip one byte
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 1]))
    assert not store.verify(path, cid)


def test_checkpoint_restore_rejects_another_tree(tmp_path):
    path = str(tmp_path / "a.ckpt")
    store.save(path, {"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="expected 1"):
        store.restore(path, {"a": torch.ones(2)})


def test_checkpoint_files_are_shared_with_the_reference(tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import store as jstore
    tree = {"b": np.arange(4, dtype=np.int32),
            "w": np.random.default_rng(0).random((3, 4)).astype(np.float32)}
    path = str(tmp_path / "port.ckpt")
    cid = store.save(path, {k: torch.from_numpy(v) for k, v in tree.items()},
                     step=3)
    assert jstore.verify(path, cid)
    got, step = jstore.restore(path, {k: jnp.zeros_like(v)
                                      for k, v in tree.items()})
    assert step == 3
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    jpath = str(tmp_path / "ref.ckpt")
    jstore.save(jpath, {k: jnp.asarray(v) for k, v in tree.items()}, step=5)
    back, step = store.restore(jpath, {k: torch.zeros(v.shape, dtype=dt)
                                       for (k, v), dt in zip(
                                           sorted(tree.items()),
                                           (torch.int32, torch.float32))})
    assert step == 5
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
