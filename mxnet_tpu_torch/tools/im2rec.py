#!/usr/bin/env python
"""Make an image list, or pack one into RecordIO (reference: tools/im2rec.py).

``python mxnet_tpu_torch/tools/im2rec.py prefix root --list [--recursive]``
writes ``prefix.lst`` (index, label, relative path); without ``--list`` it
packs the list into ``prefix.rec`` and ``prefix.idx``: through the host
library's threaded libjpeg packer (``mxtpu_im2rec_pack`` of
``src/im2rec.cc``) where it is built and the options allow, else through
PIL and :func:`mxnet_tpu_torch.recordio.pack_img`. The files are the ones
the JAX package's tool writes.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from mxnet_tpu_torch import _native, recordio  # noqa: E402

EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_image(root, recursive):
    i = 0
    if recursive:
        cat = {}
        for path, dirs, files in os.walk(root, followlinks=True):
            dirs.sort()
            files.sort()
            for fname in files:
                if os.path.splitext(fname)[1].lower() in EXTS:
                    fpath = os.path.join(path, fname)
                    if path not in cat:
                        cat[path] = len(cat)
                    yield (i, os.path.relpath(fpath, root), cat[path])
                    i += 1
    else:
        for fname in sorted(os.listdir(root)):
            if os.path.splitext(fname)[1].lower() in EXTS:
                yield (i, fname, 0)
                i += 1


def write_list(path_out, image_list):
    with open(path_out, "w") as fout:
        for idx, rel, label in image_list:
            fout.write(f"{idx}\t{label}\t{rel}\n")


def read_list(path_in):
    with open(path_in) as fin:
        for line in fin:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield (int(parts[0]), parts[-1],
                   [float(x) for x in parts[1:-1]])


def make_record_native(args):
    """The host library's packer: threaded libjpeg decode, shorter-edge
    resize and re-encode, or the bytes as they are. Returns the record
    count, or None where the library has no packer (built without libjpeg)
    or the options need PIL's semantics."""
    if not _native.host_has_jpeg():
        return None
    lib = _native.host_lib()
    if not args.pass_through and not args.resize:
        # PIL path decodes + re-encodes everything to JPEG even without
        # --resize; the native packer would pass bytes through raw — fall
        # back so the produced .rec doesn't depend on library availability
        return None
    if args.resize and not args.pass_through:
        # the native resize path only re-encodes JPEG payloads; a list with
        # PNG/BMP entries must keep PIL semantics (decode+resize+re-encode)
        with open(args.prefix + ".lst") as f:
            for line in f:
                rel = line.rstrip("\n").split("\t")[-1]
                if not rel.lower().endswith((".jpg", ".jpeg")):
                    return None
    n = lib.mxtpu_im2rec_pack(
        (args.prefix + ".lst").encode(), args.root.encode(),
        (args.prefix + ".rec").encode(), (args.prefix + ".idx").encode(),
        args.num_thread, 0 if args.pass_through else args.resize,
        args.quality)
    return None if n < 0 else int(n)


def make_record(args):
    if not args.no_native:
        n = make_record_native(args)
        if n is not None:
            print(f"wrote {n} records to {args.prefix}.rec (native)")
            return
    out_rec = args.prefix + ".rec"
    out_idx = args.prefix + ".idx"
    writer = recordio.MXIndexedRecordIO(out_idx, out_rec, "w")
    count = 0
    for idx, rel, label in read_list(args.prefix + ".lst"):
        path = os.path.join(args.root, rel)
        header = recordio.IRHeader(
            0, label[0] if len(label) == 1 else label, idx, 0)
        if args.pass_through:
            with open(path, "rb") as f:
                packed = recordio.pack(header, f.read())
        else:
            import numpy as np
            from PIL import Image

            img = Image.open(path).convert("RGB")
            if args.resize:
                w, h = img.size
                if min(w, h) != args.resize:
                    if w < h:
                        img = img.resize(
                            (args.resize, h * args.resize // w))
                    else:
                        img = img.resize(
                            (w * args.resize // h, args.resize))
            packed = recordio.pack_img(header, np.asarray(img),
                                       quality=args.quality)
        writer.write_idx(idx, packed)
        count += 1
        if count % 1000 == 0:
            print(f"processed {count} images")
    writer.close()
    print(f"wrote {count} records to {out_rec}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create an image list / RecordIO pack")
    parser.add_argument("prefix", help="output prefix")
    parser.add_argument("root", help="image root dir")
    parser.add_argument("--list", action="store_true",
                        help="create .lst list file only")
    parser.add_argument("--recursive", action="store_true",
                        help="recurse into subdirs; dir name -> label")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--resize", type=int, default=0,
                        help="resize shorter edge")
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--pass-through", action="store_true",
                        help="pack raw bytes without re-encode")
    parser.add_argument("--train-ratio", type=float, default=1.0)
    parser.add_argument("--num-thread", type=int, default=os.cpu_count() or 4,
                        help="decode/encode worker threads (native path)")
    parser.add_argument("--no-native", action="store_true",
                        help="force the pure-Python (PIL) packer")
    args = parser.parse_args(argv)

    if args.list:
        images = list(list_image(args.root, args.recursive))
        if args.shuffle:
            random.seed(100)
            random.shuffle(images)
        if args.train_ratio < 1.0:
            sep = int(len(images) * args.train_ratio)
            write_list(args.prefix + "_train.lst", images[:sep])
            write_list(args.prefix + "_val.lst", images[sep:])
        else:
            write_list(args.prefix + ".lst", images)
        print(f"listed {len(images)} images")
    else:
        make_record(args)


if __name__ == "__main__":
    main()
