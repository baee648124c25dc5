"""Checkpoints (reference: mxnet_tpu/model.py:94-325): ``save_checkpoint``,
``load_checkpoint``, ``list_checkpoints``, ``read_manifest``,
``load_latest_checkpoint`` and ``find_resume_point``; and the kvstore choice
of ``Module.init_optimizer`` (reference: model.py:38-73,
``_create_kvstore`` and ``_initialize_kvstore``).

A checkpoint is ``prefix-symbol.json``, ``prefix-NNNN.params`` (the MXTP
container of :func:`mxnet_tpu_torch.ndarray.save`, arguments under
``arg:<name>`` and aux states under ``aux:<name>``) and
``prefix-NNNN.manifest.json`` (the training position and a CRC32 of the
params file). Every file is written to a temporary name and renamed into
place, so a crash leaves the previous checkpoint whole. The formats are the
reference's: a checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import datetime
import glob
import json
import logging
import os
import re
import struct
import time
import zlib

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .convert import split_params

__all__ = ["CheckpointCorrupt", "save_checkpoint", "load_checkpoint",
           "list_checkpoints", "read_manifest", "manifest_path",
           "load_latest_checkpoint", "find_resume_point",
           "_create_kvstore", "_initialize_kvstore"]


def _create_kvstore(kvstore, num_device, arg_params):
    """The store and ``update_on_kvstore`` (reference: model.py
    ``_create_kvstore``): None, and the strings ``local`` and ``device``,
    mean no store (several contexts sum their gradients in the executor
    group and the optimizer runs locally); a ``dist*`` string creates that
    store; a :class:`~mxnet_tpu_torch.kvstore.KVStore` is used as given. The
    update runs on the store whenever there is one."""
    from . import kvstore as kvs

    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        kv = kvs.create(kvstore) if "dist" in kvstore else None
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    return kv, kv is not None


def _initialize_kvstore(kvstore, param_names, arg_params, update_on_kvstore,
                        param_arrays=None):
    """Initialise a key a parameter from ``arg_params`` (reference: model.py
    ``_initialize_kvstore``); with ``update_on_kvstore`` and
    ``param_arrays`` (a list of arrays a parameter, one a context), pull
    each key back into them, so every worker starts from rank 0's values."""
    for idx, name in enumerate(param_names):
        if name in arg_params:
            kvstore.init(name, arg_params[name])
            if update_on_kvstore and param_arrays is not None:
                kvstore.pull(name, param_arrays[idx], priority=-idx)


class CheckpointCorrupt(MXNetError):
    """A checkpoint file failed to parse or to match its manifest's CRC32;
    names the file."""

    def __init__(self, path, reason=""):
        self.path = path
        super().__init__(f"checkpoint file corrupt: {path}"
                         + (f" ({reason})" if reason else ""))


def _atomic_write(path, write_fn):
    tmp = path + ".tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def manifest_path(prefix, epoch):
    return f"{prefix}-{epoch:04d}.manifest.json"


def _file_crc32(path):
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _write_json(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    step=None, batch=None, source=None):
    """Write the symbol (when given), the parameters and, last, the
    manifest: ``epoch``, ``batch`` (batches of the epoch inside the file,
    None at an epoch's end), the optimizer ``step``, the params file's name,
    CRC32 and size, the time, and ``source`` (who wrote it)."""
    if symbol is not None:
        _atomic_write(f"{prefix}-symbol.json", symbol.save)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    tmp = param_name + ".tmp"
    nd.save(tmp, save_dict)
    crc = _file_crc32(tmp)
    nbytes = os.path.getsize(tmp)
    os.replace(tmp, param_name)
    now = time.time()
    manifest = {"format": 1, "epoch": int(epoch),
                "batch": None if batch is None else int(batch),
                "step": None if step is None else int(step),
                "params_file": os.path.basename(param_name),
                "params_crc32": crc, "params_bytes": nbytes,
                "time_unix": now,
                "created_ts": datetime.datetime.fromtimestamp(
                    now, datetime.timezone.utc).isoformat(),
                "source": None if source is None else str(source)}
    _atomic_write(manifest_path(prefix, epoch),
                  lambda p: _write_json(p, manifest))
    logging.info('Saved checkpoint to "%s"', param_name)


def list_checkpoints(prefix):
    """Epoch numbers with a ``prefix-NNNN.params`` file, ascending."""
    pat = re.compile(re.escape(os.path.basename(prefix))
                     + r"-(\d{4,})\.params$")
    epochs = []
    for path in glob.glob(f"{prefix}-*.params"):
        m = pat.match(os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def read_manifest(prefix, epoch):
    """The epoch's manifest, or None when there is none; an unreadable one
    raises :class:`CheckpointCorrupt`."""
    path = manifest_path(prefix, epoch)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(path, f"manifest: {e}") from e


def load_checkpoint(prefix, epoch, *, ctx=None):
    """``(symbol, arg_params, aux_params)`` of an epoch, the parameters as
    NDArrays on ``ctx`` (default: the current context). The params file is
    checked against its manifest's CRC32 where there is one."""
    param_name = f"{prefix}-{epoch:04d}.params"
    manifest = read_manifest(prefix, epoch)
    if manifest is not None and manifest.get("params_crc32") is not None:
        crc = _file_crc32(param_name)
        if crc != manifest["params_crc32"]:
            raise CheckpointCorrupt(
                param_name, f"crc32 {crc:#010x} != manifest "
                f"{manifest['params_crc32']:#010x}")
    symbol_name = f"{prefix}-symbol.json"
    try:
        symbol = sym.load(symbol_name)
    except (ValueError, KeyError, MXNetError) as e:
        raise CheckpointCorrupt(symbol_name, str(e)) from e
    try:
        saved = nd.load(param_name, ctx)
    except (struct.error, ValueError, MXNetError) as e:
        raise CheckpointCorrupt(param_name, str(e)) from e
    if not isinstance(saved, dict) or not all(
            k.startswith(("arg:", "aux:")) for k in saved):
        raise CheckpointCorrupt(param_name, "keys are not arg:/aux: names")
    arg_params, aux_params = split_params(saved)
    return symbol, arg_params, aux_params


def load_latest_checkpoint(prefix, max_epoch=None, *, ctx=None):
    """The newest intact checkpoint under ``prefix`` (at most
    ``max_epoch``) as ``(epoch, symbol, arg_params, aux_params,
    manifest)``, skipping corrupt ones (each logged). Raises
    :class:`MXNetError` when there is none and :class:`CheckpointCorrupt`
    when every one is corrupt."""
    epochs = [e for e in list_checkpoints(prefix)
              if max_epoch is None or e <= max_epoch]
    if not epochs:
        raise MXNetError(f"no checkpoint found for prefix '{prefix}'")
    last_err = None
    for epoch in reversed(epochs):
        try:
            symbol, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        except CheckpointCorrupt as e:
            logging.warning("skipping corrupt checkpoint: %s", e)
            last_err = e
            continue
        return epoch, symbol, args, auxs, read_manifest(prefix, epoch)
    raise last_err


def find_resume_point(prefix, *, ctx=None):
    """Where ``Module.fit(resume=True)`` restarts: ``(begin_epoch,
    resume_batch, epoch, symbol, arg_params, aux_params, manifest)`` of the
    newest intact checkpoint, or None when there is none (a fresh start).
    A manifest with ``batch=N`` means the first N batches of its epoch are
    done; one without means the epoch is complete."""
    try:
        epoch, symbol, args, auxs, manifest = load_latest_checkpoint(
            prefix, ctx=ctx)
    except MXNetError:   # none found, or every one corrupt
        return None
    if manifest is not None and manifest.get("batch") is not None:
        begin_epoch, resume_batch = int(manifest["epoch"]), \
            int(manifest["batch"])
    else:
        begin_epoch, resume_batch = epoch + 1, 0
    return begin_epoch, resume_batch, epoch, symbol, args, auxs, manifest
