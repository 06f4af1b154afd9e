"""Chunked chain runs: checkpoint after each chunk, resume bit-exact.

Counterpart of ``_mh_fused_chunked`` (``odelib_tpu/ops/pallas_mh.py``),
``_ens_fused_chunked`` (same file), ``_pt_fused_chunked``
(``ops/pallas_pt.py``), ``_joint_fused_chunked`` (``ops/pallas_joint.py``)
and ``_pf_fused_chunked`` (``ops/pallas_pf.py``).
A run of ``nits - 1`` proposals is cut into chunks of ``checkpoint_every``;
each chunk is one kernel launch (or one twin call) in chunk mode, which
starts from the chain state the previous chunk left and keys every random
word on the global iteration, so the records are bitwise those of one
launch. On the card the state stays a device tensor from chunk to chunk
and reaches the host only where a file is written.

The progress file is ``numpy``'s npz format, written to ``<path>.tmp`` and
renamed over ``<path>`` (atomic): the run's signature, ``next_chunk``, the
state and the post-burn-in records so far. The signature names this
package, so a file that ``odelib_tpu`` wrote fails the resume like any
other configuration change.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

PACKAGE = "odelib_tpu_torch"


def prior_key(prior):
    """A prior table (or None) as plain floats, for a signature."""
    return None if prior is None else np.asarray(prior, np.float64).tolist()


def digest_priors(h, parameters):
    """Feed each parameter's prior family and hyperparameters, by name,
    into the hash ``h``: the prior part of ``ModelFramework``'s and
    ``JointFit``'s config tokens (``odelib_tpu``'s
    ``_stable_config_token``), so a resume against edited priors raises."""
    for name in sorted(parameters):
        par = parameters[name]
        d = getattr(par, "dist", None)
        if d is None:
            h.update(repr((name, None)).encode())
            continue
        fam = getattr(d, "name", None) or type(d).__name__
        hp = getattr(par, "hp", None) or {}
        items = tuple(sorted((str(k), repr(np.asarray(v, float).tolist()))
                             for k, v in hp.items()))
        h.update(repr((name, str(fam), items)).encode())


def write_checkpoint(path: str, sig: str, next_chunk: int, state, recs):
    """One atomic progress write: ``path + '.tmp'``, then a rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, sig=np.frombuffer(sig.encode(), np.uint8),
                 next_chunk=np.asarray(next_chunk), state=state,
                 **{f"rec{i}": r for i, r in enumerate(recs)})
    os.replace(tmp, path)


def run(launcher: Callable, label: str, static: tuple, *, nits: int,
        burnin: int, device, checkpoint_every: Optional[int],
        checkpoint_path: Optional[str], resume_from: Optional[str],
        stop_after: Optional[int] = None):
    """A chain wrapper's run: one launch of ``launcher()``, or with
    ``checkpoint_every`` (or ``resume_from`` alone: one chunk of ``nits``)
    the proposals ``1 .. nits - 1`` in chunks.

    ``launcher(R_chunk)`` prepares a chunk length once and returns
    ``launch(it_base=, state=) -> (records, state)``, chain-minor records
    of all ``R_chunk`` rows, each with the row axis first (any number of
    them: MH's five, the joint's four with its (R, K, C) parts). The rows of burn-in iterations are dropped as
    each chunk arrives, which leaves the whole run's post-burn-in rows.
    With ``checkpoint_path`` the records so far and the state are written
    after every chunk; ``resume_from`` starts from such a file, and one
    whose signature (the repr of this package's name, the run's
    ``static`` inputs and the chunk length) differs raises ``ValueError``
    naming a different ``label`` configuration. ``stop_after`` (the wrappers'
    ``_stop_after_chunks``) returns None after that many chunks of this
    call while chunks remain, as a killed run leaves its file. Returns the
    records on ``device``."""
    if checkpoint_every is None and resume_from is None:
        return launcher()()
    R = nits - 1
    E = nits if checkpoint_every is None else int(checkpoint_every)
    if E < 1:
        raise ValueError("checkpoint_every must be >= 1")
    n_chunks = -(-R // E)
    sig = repr((PACKAGE,) + tuple(static) + (E,))
    k0, state, host = 0, None, None
    if resume_from:
        with np.load(resume_from, allow_pickle=False) as z:
            saved = bytes(z["sig"]).decode()
            if saved != sig:
                raise ValueError(
                    f"checkpoint was written by a different {label} "
                    f"configuration:\n  saved: {saved}\n  this:  {sig}")
            k0 = int(z["next_chunk"])
            if k0 > 0:
                state = torch.as_tensor(z["state"], device=device)
                host = [z[f"rec{i}"] for i in
                        range(sum(k.startswith("rec") for k in z.files))]
    recs = [] if host is None else [
        tuple(torch.as_tensor(r, device=device) for r in host)]
    launches = {}
    for k in range(k0, n_chunks):
        it_base = k * E
        R_chunk = min(E, R - it_base)
        if R_chunk not in launches:
            launches[R_chunk] = launcher(R_chunk)
        rec, state = launches[R_chunk](it_base=it_base, state=state)
        drop = min(max(burnin - it_base, 0), R_chunk)
        recs.append(tuple(r[drop:] for r in rec))
        if checkpoint_path:
            new = [r.cpu().numpy() for r in recs[-1]]
            host = new if host is None else [
                np.concatenate([a, b]) for a, b in zip(host, new)]
            write_checkpoint(checkpoint_path, sig, k + 1,
                             state.cpu().numpy(), host)
        if stop_after is not None and k + 1 - k0 >= stop_after \
                and k + 1 < n_chunks:
            return None
    return tuple(torch.cat(parts) for parts in zip(*recs))
