"""Checkpoint and resume: durable, verified, generational.

The JAX package's ``utils/checkpoint.py``, byte for byte in what it writes:
one compressed npz of the state arrays (with ``__rounds__`` and
``__stream__``) and a JSON sidecar (format 2), so a checkpoint written by
either package resumes in the other. Round keys are ``fold_in(base_key,
absolute_round)`` (ops/sampling.round_key), so a resumed run replays the
exact random stream, and the death, revival and adversary planes are
rebuilt from the config, never stored.

The state goes to numpy through ``.cpu().numpy()`` with the JAX package's
field names, order and dtypes (push-sum: ``s``, ``w`` float32, ``term``
int32, ``conv`` bool; gossip: ``count`` int32, ``active`` and ``conv``
bool), so the per-array SHA-256 digests are the same bytes in both.

- **Integrity.** The sidecar records a SHA-256 of the data archive's
  bytes, one digest per state array, and a digest of the config block.
  ``load`` verifies before deserializing: a truncated, bit-flipped or
  mispaired archive is refused with a ``CheckpointIntegrityError`` naming
  the corrupt arrays. The data file renames into place BEFORE its sidecar,
  so either crash window between the two renames leaves a pair whose
  ``data_sha256`` cannot match.
- **Generations.** ``save(..., keep=K)`` with K >= 2 writes
  ``<stem>.g<NNNNNN>.npz`` (+ sidecar) with a monotonic generation index,
  keeps ``<stem>.manifest.json``, keeps the plain path a symlink to the
  newest generation, and prunes beyond K.
- **Recovery.** ``load_latest_intact`` walks candidates newest-first,
  quarantines corrupt or mispaired pairs (renamed to ``*.corrupt``, an
  event callback, a registry counter) and returns the newest intact one.
- **Chaos seam.** ``FAULT_HOOK`` (in-process) and the
  ``GOSSIP_TPU_CKPT_FAULT`` env spec fire at every write-path point in
  ``FAULT_POINTS``: torn writes, bit flips, ENOSPC, slow-disk stalls.

Write, verify and load walls, bytes written and the generation index land
on the utils/obs.py default registry (``gossip_tpu_checkpoint_*``).
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import io
import json
import os
import re
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from ..config import SimConfig
from ..models.gossip import GossipState
from ..models.pushsum import PushSumState
from ..ops.sampling import POOL_CHOICE_BITS, STREAM_VERSION
from . import obs

# Sidecar layout version. 1 = the bare-config-dict sidecar (no digests:
# loads skip verification); 2 = the envelope {format, generation, rounds,
# stream_version, data_sha256, array_sha256, config, config_sha256}.
SIDECAR_FORMAT = 2

# Every write-path site the chaos plane can interrupt, in save() order.
# tests/test_torch_checkpoint.py sweeps a kill at each one and pins that
# load_latest_intact recovers to a bitwise-equal completed run.
FAULT_POINTS = (
    "save-enter",            # nothing written yet (the ENOSPC/stall site)
    "data-tmp-written",      # tmp archive on disk, nothing renamed
    "before-data-rename",
    "after-data-rename",     # new data + old/absent sidecar (mispair window)
    "sidecar-tmp-written",
    "before-sidecar-rename",
    "after-sidecar-rename",  # pair complete; links/manifest may lag
    "before-manifest-rename",  # keep >= 2 only
    "after-manifest-rename",   # keep >= 2 only
    "save-done",             # save fully complete (at-rest corruption site)
)

# In-process fault seam: tests set ``checkpoint.FAULT_HOOK = fn`` and the
# hook is called as fn(point, path) at every FAULT_POINTS site. Raise (a
# BaseException subclass passes every except clause of the run) to
# simulate a kill; mutate files to simulate corruption.
FAULT_HOOK = None

# Env-gated fault spec for subprocess chaos campaigns (the JAX package's
# spec and variable, so one campaign drives either package's CLI):
#   GOSSIP_TPU_CKPT_FAULT="torn:<nth>[:<offset>]"    truncate the just-
#       written data file of the nth save (0-based) at byte <offset>
#       (default: half its size), then _exit — a torn write the atomic
#       rename cannot mask (filesystem-level damage at rest).
#   GOSSIP_TPU_CKPT_FAULT="flip:<nth>[:<offset>]"    flip one bit of the
#       nth save's data file post-write, then _exit — silent at-rest
#       corruption the digests must catch.
#   GOSSIP_TPU_CKPT_FAULT="enospc:<nth>[:<count>]"   raise
#       OSError(ENOSPC) from <count> consecutive saves starting at the
#       nth — exercises the run_chunks checkpoint-hook failure policy.
#   GOSSIP_TPU_CKPT_FAULT="stall:<nth>[:<seconds>]"  sleep at the nth
#       save's entry (slow-disk stall; the run must simply absorb it).
FAULT_ENV = "GOSSIP_TPU_CKPT_FAULT"

_ENV_STATE = {"saves": 0, "enospc_left": None}

_GEN_RE_NPZ = r"\.g(\d+)\.npz$"

_WRITE_HIST = "gossip_tpu_checkpoint_write_seconds"
_VERIFY_HIST = "gossip_tpu_checkpoint_verify_seconds"
_LOAD_HIST = "gossip_tpu_checkpoint_load_seconds"
_BYTES_TOTAL = "gossip_tpu_checkpoint_bytes_written_total"
_GEN_GAUGE = "gossip_tpu_checkpoint_generation"
_QUARANTINE_TOTAL = "gossip_tpu_checkpoint_quarantined_total"


class CheckpointIntegrityError(ValueError):
    """A checkpoint pair failed content verification: truncated or
    bit-flipped archive, mispaired data/sidecar generations, or a corrupt
    sidecar. ValueError subclass on purpose — every pre-existing refusal
    path (cli --resume auto's fallback, the chaos harness) already
    catches ValueError, so integrity refusals flow through the same
    structured channel as stream-version refusals."""

    def __init__(self, path, reason: str, corrupt_arrays=()):
        self.path = Path(path)
        self.reason = reason
        self.corrupt_arrays = tuple(corrupt_arrays)
        detail = (
            f" (corrupt arrays: {', '.join(self.corrupt_arrays)})"
            if self.corrupt_arrays else ""
        )
        super().__init__(
            f"checkpoint {path} failed integrity verification: "
            f"{reason}{detail}; refusing to load it — load_latest_intact "
            "(--resume auto) falls back to the newest intact generation"
        )


def _to_numpy(x) -> np.ndarray:
    """A state array on the host: a tensor through ``.cpu().numpy()``,
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize(path: str | Path) -> Path:
    """np.savez appends .npz to suffix-less paths; normalize up front so the
    archive and its JSON sidecar always agree on the stem."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def _sidecar_for(data: Path) -> Path:
    return data.with_suffix(data.suffix + ".json")


def _manifest_for(path: Path) -> Path:
    return path.with_name(path.stem + ".manifest.json")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _config_sha256(cfg_dict: dict) -> str:
    return _digest(json.dumps(cfg_dict, sort_keys=True).encode())


def _fault(point: str, path: Path) -> None:
    hook = FAULT_HOOK
    if hook is not None:
        hook(point, path)
    spec = os.environ.get(FAULT_ENV)
    if spec:
        _env_fault(spec, point, path)


def _env_fault(spec: str, point: str, path: Path) -> None:
    """Interpret the GOSSIP_TPU_CKPT_FAULT spec at one fault point. The
    per-process save counter advances at save-enter, so `nth` counts
    save() calls, not fault sites."""
    parts = spec.split(":")
    mode, nth = parts[0], int(parts[1]) if len(parts) > 1 else 0
    arg = parts[2] if len(parts) > 2 else None
    if point == "save-enter":
        idx = _ENV_STATE["saves"]
        _ENV_STATE["saves"] += 1
        if mode == "stall" and idx == nth:
            time.sleep(float(arg) if arg else 2.0)
        if mode == "enospc":
            if idx == nth:
                _ENV_STATE["enospc_left"] = int(arg) if arg else 1
            left = _ENV_STATE["enospc_left"]
            if left is not None and left > 0:
                _ENV_STATE["enospc_left"] = left - 1
                raise OSError(
                    errno.ENOSPC, "No space left on device (injected)",
                    str(path),
                )
        return
    if point == "save-done" and _ENV_STATE["saves"] - 1 == nth:
        if mode == "torn":
            size = path.stat().st_size
            offset = int(arg) if arg else size // 2
            with open(path, "r+b") as f:
                f.truncate(offset)
            os._exit(17)
        if mode == "flip":
            size = path.stat().st_size
            offset = int(arg) if arg else size // 2
            with open(path, "r+b") as f:
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([b[0] ^ 0x40]))
            os._exit(19)


def _generation_files(path: Path) -> list:
    """[(generation, data_path)] for every on-disk generation of this
    checkpoint stem, sorted ascending. Quarantined ``*.corrupt`` files do
    not match and are never candidates again."""
    pat = re.compile(re.escape(path.stem) + _GEN_RE_NPZ)
    out = []
    for p in path.parent.glob(path.stem + ".g*.npz"):
        m = pat.search(p.name)
        if m:
            out.append((int(m.group(1)), p))
    out.sort()
    return out


def _next_generation(path: Path) -> int:
    """Monotonic across the stem's whole history: generation files,
    the manifest's record, and a plain-path format-2 sidecar all count."""
    gens = [g for g, _ in _generation_files(path)]
    man = _manifest_for(path)
    if man.exists():
        try:
            rec = json.loads(man.read_text())
            gens += [int(e["generation"]) for e in rec.get("generations", ())]
        except (ValueError, KeyError, TypeError, OSError):
            pass
    side = _sidecar_for(path)
    if side.exists():
        try:
            rec = json.loads(side.read_text())
            if isinstance(rec, dict) and "generation" in rec:
                gens.append(int(rec["generation"]))
        except (ValueError, TypeError, OSError):
            pass
    return max(gens) + 1 if gens else 0


def _replace_link(link: Path, target_name: str) -> None:
    """Atomically point ``link`` at ``target_name`` (same directory). The
    plain checkpoint path stays resolvable across generations, so every
    pre-generation consumer (``Path(ck).exists()`` probes, plain load)
    keeps working."""
    tmp = link.with_name(link.name + ".tmp-link")
    try:
        tmp.unlink()
    except FileNotFoundError:
        pass
    tmp.symlink_to(target_name)
    tmp.replace(link)


def _write_manifest(path: Path, keep: int) -> None:
    entries = []
    for g, p in _generation_files(path):
        rounds = None
        try:
            rec = json.loads(_sidecar_for(p).read_text())
            rounds = rec.get("rounds")
        except (ValueError, OSError):
            pass
        entries.append({"generation": g, "data": p.name, "rounds": rounds})
    man = _manifest_for(path)
    tmp = man.with_name(man.name + ".tmp")
    tmp.write_text(json.dumps({
        "format": SIDECAR_FORMAT,
        "keep": keep,
        "generations": entries,
    }, indent=2))
    tmp.replace(man)


def _prune(path: Path, keep: int) -> None:
    gens = _generation_files(path)
    for _, p in gens[:-keep] if keep > 0 else gens:
        for victim in (p, _sidecar_for(p)):
            try:
                victim.unlink()
            except FileNotFoundError:
                pass


def save(path: str | Path, state, rounds: int, cfg: SimConfig,
         *, keep: int = 1) -> dict:
    """Write state arrays + round counter + config; returns
    ``{"path", "generation", "bytes", "write_s"}`` for the caller's
    checkpoint-written event. ``state`` is a PushSumState or GossipState.

    Both files land via write-to-temp + atomic rename, the DATA archive
    strictly before its sidecar: a run killed mid-checkpoint (the exact
    population --resume auto exists for) leaves either the previous
    complete pair or a mispair the sidecar's ``data_sha256`` refuses —
    never a silently wrong resume. With ``keep >= 2`` each save is a new
    ``<stem>.g<NNNNNN>.npz`` generation (manifest updated, plain path
    re-linked to the newest, oldest pruned beyond ``keep``), so a corrupt
    newest generation costs one interval, not the run."""
    t0 = time.perf_counter()
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    keep = max(1, int(keep))
    _fault("save-enter", path)
    gen = _next_generation(path)
    data = (
        path if keep == 1
        else path.with_name(f"{path.stem}.g{gen:06d}.npz")
    )
    arrays = {f: _to_numpy(getattr(state, f)) for f in state._fields}
    # The .npz suffix on the temp name keeps np.savez from appending one.
    tmp = data.with_name(data.name + ".tmp.npz")
    np.savez_compressed(
        tmp, __rounds__=rounds, __stream__=STREAM_VERSION, **arrays
    )
    _fault("data-tmp-written", tmp)
    cfg_dict = dataclasses.asdict(cfg)
    meta = {
        "format": SIDECAR_FORMAT,
        "generation": gen,
        "rounds": int(rounds),
        "stream_version": STREAM_VERSION,
        "data_sha256": _digest(tmp.read_bytes()),
        "array_sha256": {
            name: _digest(a.tobytes()) for name, a in arrays.items()
        },
        "config": cfg_dict,
        "config_sha256": _config_sha256(cfg_dict),
    }
    _fault("before-data-rename", tmp)
    tmp.replace(data)
    _fault("after-data-rename", data)
    sidecar = _sidecar_for(data)
    tmp_side = sidecar.with_name(sidecar.name + ".tmp")
    tmp_side.write_text(json.dumps(meta, indent=2))
    _fault("sidecar-tmp-written", tmp_side)
    _fault("before-sidecar-rename", tmp_side)
    tmp_side.replace(sidecar)
    _fault("after-sidecar-rename", sidecar)
    nbytes = data.stat().st_size
    if keep > 1:
        # Newest pair is durable; everything below is repairable garnish —
        # a crash here leaves a stale link/manifest that the next save (or
        # load_latest_intact's glob walk) heals.
        _replace_link(path, data.name)
        _replace_link(_sidecar_for(path), sidecar.name)
        _prune(path, keep)
        _fault("before-manifest-rename", path)
        _write_manifest(path, keep)
        _fault("after-manifest-rename", path)
    write_s = time.perf_counter() - t0
    reg = obs.default_registry()
    reg.histogram(
        _WRITE_HIST, "checkpoint.save wall seconds (archive + sidecar + "
        "generation bookkeeping)").observe(write_s)
    reg.counter(
        _BYTES_TOTAL, "compressed checkpoint archive bytes written"
    ).inc(nbytes)
    reg.gauge(
        _GEN_GAUGE, "newest written checkpoint generation index"
    ).set(gen)
    _fault("save-done", data)
    return {
        "path": str(data), "generation": gen, "bytes": int(nbytes),
        "write_s": write_s,
    }


def _verify_pair(path: Path, meta: dict, data_bytes: bytes) -> None:
    """Format-2 verification: refuse with a structured error naming what
    is corrupt. Raises CheckpointIntegrityError; returns None when the
    pair is intact."""
    cfg_dict = meta.get("config")
    if not isinstance(cfg_dict, dict):
        raise CheckpointIntegrityError(
            path, "sidecar has no config block (sidecar corrupt)")
    want_cfg = meta.get("config_sha256")
    if want_cfg and _config_sha256(cfg_dict) != want_cfg:
        raise CheckpointIntegrityError(
            path, "sidecar config block does not match its recorded digest "
            "(sidecar corrupt)")
    want_data = meta.get("data_sha256")
    if not want_data or _digest(data_bytes) == want_data:
        return
    # The archive's bytes are not the ones this sidecar described. Name
    # the damage: open it (if it still opens) and hash each array.
    try:
        with np.load(io.BytesIO(data_bytes)) as z:
            saved_rounds = (
                int(z["__rounds__"]) if "__rounds__" in z.files else None
            )
            corrupt = []
            want_arrays = meta.get("array_sha256") or {}
            for name in z.files:
                if name in ("__rounds__", "__stream__"):
                    continue
                want = want_arrays.get(name)
                if want is None or _digest(
                        np.asarray(z[name]).tobytes()) != want:
                    corrupt.append(name)
            missing = sorted(set(want_arrays) - set(z.files))
            corrupt += [f"{name} (missing)" for name in missing]
    except (zipfile.BadZipFile, OSError, ValueError, EOFError, KeyError):
        raise CheckpointIntegrityError(
            path, "data archive is unreadable (truncated or torn write)")
    if saved_rounds is not None and saved_rounds != meta.get("rounds"):
        raise CheckpointIntegrityError(
            path, f"data file holds rounds={saved_rounds} but the sidecar "
            f"records rounds={meta.get('rounds')} — the pair is mispaired "
            "generations (crash between the data and sidecar renames)")
    raise CheckpointIntegrityError(
        path, "data archive does not match the sidecar's recorded digest",
        corrupt_arrays=corrupt)


def _read_sidecar(path: Path) -> dict:
    sidecar = _sidecar_for(path)
    try:
        raw = sidecar.read_text()
    except FileNotFoundError:
        raise CheckpointIntegrityError(
            path, "config sidecar is missing (partial write)")
    except OSError as e:
        raise CheckpointIntegrityError(
            path, f"config sidecar is unreadable ({e})")
    try:
        meta = json.loads(raw)
    except ValueError:
        raise CheckpointIntegrityError(
            path, "config sidecar is not valid JSON (torn sidecar write)")
    if not isinstance(meta, dict):
        raise CheckpointIntegrityError(
            path, "config sidecar is not a JSON object")
    return meta


def load(path: str | Path):
    """Returns (state, rounds, cfg), the state's arrays CPU tensors. State
    class is inferred from the saved field names. Format-2 pairs are digest-verified first — corruption and
    mispairs raise a structured CheckpointIntegrityError, never a numpy
    traceback; format-1 (pre-digest) sidecars load unverified as before."""
    t0 = time.perf_counter()
    path = _normalize(path)
    meta = _read_sidecar(path)
    legacy = meta.get("format") is None
    try:
        data_bytes = path.read_bytes()
    except FileNotFoundError:
        raise
    t_verify = time.perf_counter()
    if not legacy:
        _verify_pair(path, meta, data_bytes)
    verify_s = time.perf_counter() - t_verify
    try:
        with np.load(io.BytesIO(data_bytes)) as z:
            rounds = int(z["__rounds__"])
            # Pre-marker checkpoints are of unknown stream version; for
            # configs that consume a changed stream they are rejected below
            # (rejection beats a silently divergent resume).
            stream = int(z["__stream__"]) if "__stream__" in z.files else None
            fields = {
                k: z[k] for k in z.files
                if k not in ("__rounds__", "__stream__")
            }
    except (zipfile.BadZipFile, EOFError) as e:
        # Reachable only for legacy pairs (format 2 verified above): keep
        # the refusal structured all the same.
        raise CheckpointIntegrityError(
            path, f"data archive is unreadable ({e})")
    cfg_src = meta["config"] if not legacy else meta
    cfg = SimConfig(**cfg_src)
    # Stream changes invalidate only checkpoints whose config CONSUMES a
    # stream that changed BETWEEN the written and current versions (the
    # JAX package's sampling.STREAM_VERSION history): v1 -> v2 altered the
    # packed pool-choice derivation (scatter/stencil runs and pool_size >
    # 16 runs replay bitwise under either); v2 -> v3 altered only the
    # fault-gate draws; v3 -> v4 only ADDED the revival-plane stream; v4 ->
    # v5 only ADDED the byzantine adversary-plane stream, so a v4
    # checkpoint without a byzantine model loads bitwise under v5 and a
    # byzantine config refuses any pre-v5 archive. Checkpoints from a
    # NEWER stream than this build refuse on any sensitivity. Matmul
    # delivery consumes the pool tier's packed pool-choice stream, so it
    # is pool-stream-sensitive too.
    pool_sensitive = (
        cfg.delivery in ("pool", "matmul")
        and cfg.pool_size <= 1 << POOL_CHOICE_BITS
    )
    gate_sensitive = cfg.fault_rate > 0 or cfg.dup_rate > 0
    revive_sensitive = cfg.revive_model
    byz_sensitive = cfg.byzantine_model
    sv = 0 if stream is None else stream
    invalid = (
        (pool_sensitive and sv < 2)
        or (gate_sensitive and sv < 3)
        or (revive_sensitive and sv < 4)
        or (byz_sensitive and sv < 5)
        # A NEWER stream than this build: what changed is unknowable here,
        # so no sensitivity classification applies — always refuse.
        or sv > STREAM_VERSION
    )
    if invalid:
        written = (
            f"under random-stream version {stream}" if stream is not None
            else "before stream versioning (version unknown)"
        )
        raise ValueError(
            f"checkpoint {path} was written {written}; this build derives "
            f"version {STREAM_VERSION} for its pool-choice draws — resuming "
            "could silently follow a different trajectory than the run that "
            "wrote it; restart the run (or check out the matching framework "
            "version)"
        )
    cls = PushSumState if "s" in fields else GossipState
    state = cls(**{f: torch.from_numpy(np.ascontiguousarray(fields[f]))
                   for f in cls._fields})
    reg = obs.default_registry()
    reg.histogram(
        _VERIFY_HIST, "checkpoint digest-verification wall seconds"
    ).observe(verify_s)
    reg.histogram(
        _LOAD_HIST, "checkpoint.load wall seconds (verify included)"
    ).observe(time.perf_counter() - t0)
    return state, rounds, cfg


def candidate_paths(path: str | Path) -> list:
    """Every loadable candidate for this checkpoint stem, newest-first:
    generation files by descending index, then the plain path when it is
    a real file of its own (legacy keep=1 layout; as a symlink it merely
    aliases a generation already listed — and a dangling one aliases a
    quarantined file). ``--resume auto`` probes this instead of a bare
    Path.exists() so a quarantined newest generation still resumes."""
    path = _normalize(path)
    out = [p for _, p in reversed(_generation_files(path))]
    if path.exists() and not path.is_symlink() and path not in out:
        out.append(path)
    return out


def _quarantine(cand: Path, err: CheckpointIntegrityError,
                on_event=None) -> None:
    moved = []
    for victim in (cand, _sidecar_for(cand)):
        if victim.exists() or victim.is_symlink():
            dest = victim.with_name(victim.name + ".corrupt")
            try:
                victim.replace(dest)
                moved.append(dest.name)
            except OSError:
                pass
    obs.default_registry().counter(
        _QUARANTINE_TOTAL,
        "checkpoint generations quarantined as corrupt/mispaired"
    ).inc()
    if on_event is not None:
        on_event(
            path=str(cand), reason=err.reason,
            corrupt_arrays=list(err.corrupt_arrays), quarantined=moved,
        )


def load_latest_intact(path: str | Path, *, on_event=None):
    """Walk this stem's candidates newest-first; quarantine corrupt or
    mispaired pairs (rename to ``*.corrupt``, fire ``on_event(path=...,
    reason=..., corrupt_arrays=..., quarantined=...)`` — the caller's
    checkpoint-corrupt-quarantined event — and bump the registry counter)
    and return ``(state, rounds, cfg, info)`` for the newest generation
    that verifies, or None when none does. Stream-version refusals
    re-raise: an intact-but-incompatible archive means every older
    sibling is incompatible too, so falling back cannot help."""
    path = _normalize(path)
    for cand in candidate_paths(path):
        try:
            state, rounds, cfg = load(cand)
        except CheckpointIntegrityError as e:
            _quarantine(cand, e, on_event)
            continue
        except FileNotFoundError:
            continue
        info = {"path": str(cand)}
        try:
            info["generation"] = json.loads(
                _sidecar_for(cand).read_text()).get("generation")
        except (ValueError, OSError):
            info["generation"] = None
        return state, rounds, cfg, info
    return None


def _refresh_digests(path: str | Path) -> None:
    """Re-bless a format-2 pair after the data archive was rewritten in
    place (test seam: the stream-marker downgrade tests re-serialize the
    npz and must not trip integrity verification; they target the
    stream-sensitivity refusal, not the digest one)."""
    path = _normalize(path)
    meta = _read_sidecar(path)
    data_bytes = path.read_bytes()
    with np.load(io.BytesIO(data_bytes)) as z:
        meta["rounds"] = int(z["__rounds__"])
        if "__stream__" in z.files:
            meta["stream_version"] = int(z["__stream__"])
        meta["array_sha256"] = {
            name: _digest(np.asarray(z[name]).tobytes())
            for name in z.files if name not in ("__rounds__", "__stream__")
        }
    meta["data_sha256"] = _digest(data_bytes)
    sidecar = _sidecar_for(path)
    tmp = sidecar.with_name(sidecar.name + ".tmp")
    tmp.write_text(json.dumps(meta, indent=2))
    tmp.replace(sidecar)
