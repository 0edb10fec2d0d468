"""The port's store (``repro_torch.store``) against the JAX package's
``repro.store``: backend semantics, codec tamper-evidence, URI and
environment resolution (the port's default directory is its own), the
envelope decoded across the two packages, equal request digests, and the
shared directory backend under concurrent writer processes.

The multiprocess test is the dynamic side of "never serve a torn entry":
spawn-context writers hammer one key while readers decode everything they
see; a non-atomic write (a plain ``open(...).write``) fails it.  Its counts
are small enough to stay steady beside other test workers, and every join
has a timeout.
"""

import multiprocessing
import os

import pytest

pytest.importorskip("torch")

from repro.store import codec as jcodec  # noqa: E402
from repro.store import keys as jkeys  # noqa: E402
from repro.plan import Budget as JBudget  # noqa: E402
from repro.plan import PlanRequest as JRequest  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.plan import Budget, PlanRequest  # noqa: E402
from repro_torch.store import (  # noqa: E402
    QUARANTINE_DIR,
    CorruptEntryError,
    LocalDirectoryBackend,
    MemoryBackend,
    ObjectStore,
    SharedDirectoryBackend,
    StoreError,
    decode,
    default_cache_dir,
    encode,
    from_uri,
    request_digest,
    resolve_settings,
    validate_key,
)

# -- keys --------------------------------------------------------------------


def test_validate_key_accepts_namespaced_keys():
    assert validate_key("plans/tenant-a/abc.def.123") is not None


@pytest.mark.parametrize(
    "key", ["", "bad key", "a//b", "seg__ment/x", "a/:b", "../escape"]
)
def test_validate_key_rejects_unportable_keys(key):
    with pytest.raises(StoreError):
        validate_key(key)


# -- codec -------------------------------------------------------------------


def test_codec_roundtrip():
    data = encode("object", "ns/k", {"x": 1, "y": [1.5, None]})
    kind, key, obj = decode(data, kind="object", key="ns/k")
    assert (kind, key) == ("object", "ns/k")
    assert obj == {"x": 1, "y": [1.5, None]}


def test_codec_detects_byte_tamper():
    data = bytearray(encode("object", "k", {"payload": "x" * 256}))
    data[len(data) // 2] ^= 0xFF
    with pytest.raises(CorruptEntryError):
        decode(bytes(data), key="k")


def test_codec_detects_truncation():
    data = encode("object", "k", {"payload": "x" * 256})
    with pytest.raises(CorruptEntryError):
        decode(data[: len(data) // 2], key="k")


def test_codec_rejects_wrong_kind_and_key():
    data = encode("object", "k", 42)
    with pytest.raises(CorruptEntryError):
        decode(data, kind="frontier", key="k")
    with pytest.raises(CorruptEntryError):
        decode(data, kind="object", key="other")


def test_codec_rejects_foreign_bytes():
    with pytest.raises(CorruptEntryError):
        decode(b"not an envelope at all")


PAYLOAD = {"x": 1, "y": [1.5, None], "name": "plan", "t": (2, 3.25)}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_envelope_decodes_in_the_other_package(direction):
    """The envelope layout is the JAX package's: a plain-Python payload
    encoded by either package decodes in the other, with its kind and key,
    and a tampered one is refused by both."""
    enc, dec = ((jcodec.encode, decode) if direction == "jax-to-port"
                else (encode, jcodec.decode))
    data = enc("object", "ns/k", PAYLOAD)
    assert dec(data, kind="object", key="ns/k") == ("object", "ns/k",
                                                     PAYLOAD)
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        dec(bytes(bad), key="ns/k")


# -- backends ----------------------------------------------------------------


def test_memory_backend_lru_eviction():
    b = MemoryBackend(capacity=2)
    b.put("ns/a", b"1")
    b.put("ns/b", b"2")
    assert b.get("ns/a") == b"1"  # refresh a
    b.put("ns/c", b"3")  # evicts b
    assert b.get("ns/b") is None
    assert b.get("ns/a") == b"1" and b.get("ns/c") == b"3"
    assert sorted(b.keys("ns")) == ["ns/a", "ns/c"]


def test_directory_backend_roundtrip_and_layout(tmp_path):
    b = LocalDirectoryBackend(tmp_path)
    b.put("plans/tenant-a/k1", b"payload")
    assert b.get("plans/tenant-a/k1") == b"payload"
    # '/' flattens to '__' in filenames so namespaces survive one flat dir
    (entry,) = [p for p in os.listdir(tmp_path) if p.endswith(".pkl")]
    assert entry == "plans__tenant-a__k1.pkl"
    assert b.keys("plans/tenant-a") == ["plans/tenant-a/k1"]
    assert b.delete("plans/tenant-a/k1")
    assert b.get("plans/tenant-a/k1") is None


def test_directory_backend_prunes_oldest(tmp_path):
    b = LocalDirectoryBackend(tmp_path, max_entries=2)
    for i in range(4):
        b.put(f"ns/k{i}", bytes([i]))
        os.utime(
            tmp_path / f"ns__k{i}.pkl", (1_000_000 + i, 1_000_000 + i)
        )
    b.put("ns/k4", b"\x04")
    names = sorted(p for p in os.listdir(tmp_path) if p.endswith(".pkl"))
    assert len(names) <= 2
    assert "ns__k4.pkl" in names  # newest survives


def test_quarantine_moves_entry_aside(tmp_path):
    b = LocalDirectoryBackend(tmp_path)
    b.put("ns/bad", b"zzz")
    assert b.quarantine("ns/bad")
    assert b.get("ns/bad") is None
    qdir = tmp_path / QUARANTINE_DIR
    assert len(list(qdir.iterdir())) == 1


def test_object_store_quarantines_corrupt_entries(tmp_path):
    from repro_torch.obs import metrics

    metrics.reset()
    b = LocalDirectoryBackend(tmp_path)
    store = ObjectStore(b, name="store")
    store.put("ns/k", {"fine": True})
    # corrupt the bytes behind the store's back
    (tmp_path / "ns__k.pkl").write_bytes(b"garbage")
    assert store.get("ns/k") is None
    assert store.stats()["corrupt"] == 1
    assert (tmp_path / QUARANTINE_DIR).exists()
    # quarantined: the next read is a plain miss, not another corruption
    assert store.get("ns/k") is None
    assert store.stats()["corrupt"] == 1
    # every outcome is mirrored into the port's metrics
    assert metrics.value("store.puts") == 1
    assert metrics.value("store.corrupt_quarantined") == 1
    assert metrics.value("store.misses") == 2


# -- URI / env resolution ----------------------------------------------------


def test_from_uri_schemes(tmp_path):
    assert isinstance(from_uri("memory://"), MemoryBackend)
    local = from_uri(f"file://{tmp_path}/sub")
    assert isinstance(local, LocalDirectoryBackend)
    shared = from_uri(f"shared://{tmp_path}/sub2")
    assert isinstance(shared, SharedDirectoryBackend)
    bare = from_uri(str(tmp_path / "sub3"))
    assert isinstance(bare, LocalDirectoryBackend)
    with pytest.raises(StoreError):
        from_uri("s3://nope")


def test_repro_store_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_STORE", f"file://{tmp_path}")
    s = resolve_settings()
    assert s.enabled and s.uri == f"file://{tmp_path}"
    monkeypatch.setenv("REPRO_STORE", "off")
    assert not resolve_settings().enabled


def test_legacy_env_mapped_with_deprecation(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_STORE", raising=False)
    monkeypatch.setenv("REPRO_SOLVER_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_SOLVER_CACHE_SIZE", "7")
    with pytest.warns(DeprecationWarning, match="REPRO_SOLVER_CACHE_DIR"):
        s = resolve_settings()
    assert s.enabled and s.uri == f"file://{tmp_path}"
    assert s.mem_entries == 7
    monkeypatch.setenv("REPRO_SOLVER_CACHE", "0")
    with pytest.warns(DeprecationWarning, match="REPRO_SOLVER_CACHE"):
        assert not resolve_settings().enabled


def test_repro_store_wins_over_legacy(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_STORE", "memory://")
    monkeypatch.setenv("REPRO_SOLVER_CACHE_DIR", str(tmp_path))
    s = resolve_settings()
    assert s.enabled and s.uri == "memory://"


def test_default_directory_is_the_ports_own(monkeypatch, tmp_path):
    """Unset, the store lives under ``$XDG_CACHE_HOME/repro_torch/``, never
    in the JAX package's ``repro/solver-cache``."""
    from repro.store import config as jconfig

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    for var in ("REPRO_STORE", "REPRO_SOLVER_CACHE", "REPRO_SOLVER_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert default_cache_dir() == tmp_path / "repro_torch" / "solver-cache"
    assert default_cache_dir() != jconfig.default_cache_dir()
    s = resolve_settings()
    assert s.uri == f"file://{tmp_path / 'repro_torch' / 'solver-cache'}"


# -- request digests ---------------------------------------------------------

REQUESTS = {
    "optimal-bytes": dict(strategy="optimal", budget=("bytes", 1.5e9)),
    "optimal-fraction": dict(strategy="optimal", budget=("fraction", 0.6),
                             num_slots=64),
    "revolve-auto": dict(strategy="revolve", budget=("auto", None)),
    "min-memory": dict(strategy="min_memory"),
    "periodic": dict(strategy="periodic", segments=3),
    "offload": dict(strategy="optimal", budget=("bytes", 8e8),
                    tiers=("device", "host"), host=(1e10, 2e10, 1e-5)),
    "fallback": dict(strategy="optimal", budget=("fraction", 0.3),
                     on_infeasible="min_memory", num_slots=500),
}


def _requests(spec):
    budgets = {"bytes": (Budget.bytes, JBudget.bytes),
               "fraction": (Budget.fraction, JBudget.fraction),
               "auto": (lambda _: Budget.auto(), lambda _: JBudget.auto())}
    out = []
    for i, (req, host) in enumerate(((PlanRequest, PHost),
                                     (JRequest, JHost))):
        kw = {k: v for k, v in spec.items() if k not in ("budget", "host")}
        if "budget" in spec:
            kind, value = spec["budget"]
            kw["budget"] = budgets[kind][i](value)
        if "host" in spec:
            d2h, h2d, lat = spec["host"]
            kw["host"] = host(bandwidth_d2h=d2h, bandwidth_h2d=h2d,
                              latency=lat)
        out.append(req(impl="banded", **kw))
    return out


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_request_digest_equals_jax(name):
    """Equivalent requests on ``impl="banded"`` hash to the JAX package's
    digest; the default slot count and an explicit 500 are one request."""
    got, want = _requests(REQUESTS[name])
    assert request_digest(got) == jkeys.request_digest(want)
    if got.num_slots is None:
        import dataclasses
        assert request_digest(dataclasses.replace(got, num_slots=500)) == \
            request_digest(got)


# -- cross-process atomicity -------------------------------------------------

_N_WRITES = 24
_BLOB = b"x" * 8192


def _writer(dirpath: str, wid: int) -> None:
    from repro_torch.store.backend import SharedDirectoryBackend
    from repro_torch.store.codec import encode

    b = SharedDirectoryBackend(dirpath)
    for i in range(_N_WRITES):
        payload = {"writer": wid, "i": i, "blob": _BLOB}
        b.put("ns/contended", encode("object", "ns/contended", payload))


def _reader(dirpath: str, queue) -> None:
    import time

    from repro_torch.store.backend import SharedDirectoryBackend
    from repro_torch.store.codec import CorruptEntryError, decode

    b = SharedDirectoryBackend(dirpath)
    seen, torn = 0, 0
    deadline = time.monotonic() + 60
    # read until _N_WRITES entries decoded (the last one stays readable
    # once the writers are done), whenever the writers start
    while seen < _N_WRITES and time.monotonic() < deadline:
        data = b.get("ns/contended")
        if data is None:
            time.sleep(0.001)
            continue
        try:
            decode(data, key="ns/contended")
            seen += 1
        except CorruptEntryError:
            torn += 1
    queue.put((seen, torn))


def test_shared_backend_concurrent_writers_never_torn(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    writers = [
        ctx.Process(target=_writer, args=(str(tmp_path), w)) for w in range(3)
    ]
    readers = [
        ctx.Process(target=_reader, args=(str(tmp_path), queue))
        for _ in range(2)
    ]
    for p in writers + readers:
        p.start()
    try:
        # drain the queue before joining the readers that wrote to it
        results = [queue.get(timeout=120) for _ in readers]
        for p in writers + readers:
            p.join(timeout=120)
            assert not p.is_alive() and p.exitcode == 0
    finally:
        for p in writers + readers:
            if p.is_alive():
                p.kill()
    total_seen = sum(seen for seen, _ in results)
    total_torn = sum(torn for _, torn in results)
    assert total_torn == 0, f"{total_torn} torn reads"
    assert total_seen > 0
    # and the final entry decodes
    b = SharedDirectoryBackend(str(tmp_path))
    _, _, obj = decode(b.get("ns/contended"), key="ns/contended")
    assert obj["i"] == _N_WRITES - 1
