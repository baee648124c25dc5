"""The port's iterators against the JAX package's, on the CPU: ``CSVIter``,
``MNISTIter`` (idx files made here, plain and gzipped), ``ResizeIter``,
``PrefetchingIter`` (one producer thread, and the ordered pool of decode
threads over ``NDArrayIter``'s and ``ImageIter``'s decode plans), and
``DevicePrefetchIter``, whose batches and training (also through ``fit``'s
``MXNET_DEVICE_PREFETCH=1``) are bit-identical to the synchronous feed's,
with its reset and end-of-epoch behaviour. Batches are compared exactly:
both packages slice the same numpy arrays."""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

DATA = np.arange(80, dtype=np.float32).reshape(20, 4)
LABEL = (np.arange(20) % 3).astype(np.float32)


def _collect(it):
    return [([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in b.label],
             b.pad) for b in it]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("with_label", [True, False])
def test_csv_iter_matches_reference(tmp_path, round_batch, with_label):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((11, 6)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              batch_size=4, round_batch=round_batch)
    if with_label:
        np.savetxt(tmp_path / "l.csv", np.arange(11.0)[:, None] % 5,
                   delimiter=",")
        kw["label_csv"] = str(tmp_path / "l.csv")
    out = {}
    for pkg in (mxt, mxj):
        it = pkg.io.CSVIter(**kw)
        assert [tuple(d.shape) for d in it.provide_data] == [(4, 2, 3)]
        first = _collect(it)
        it.reset()
        out[pkg] = first + _collect(it)
    _assert_same(out[mxt], out[mxj])


def _idx_file(path, arr, gz):
    header = struct.pack(">I", 0x800 + arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter_matches_reference(tmp_path, gz, flat, shuffle):
    rng = np.random.default_rng(1)
    ext = ".gz" if gz else ""
    _idx_file(str(tmp_path / f"img{ext}"),
              rng.integers(0, 256, (13, 28, 28)), gz)
    _idx_file(str(tmp_path / f"lab{ext}"), rng.integers(0, 10, 13), gz)
    out = {}
    for pkg in (mxt, mxj):
        np.random.seed(3)   # the shuffle
        it = pkg.io.MNISTIter(str(tmp_path / f"img{ext}"),
                              str(tmp_path / f"lab{ext}"), batch_size=5,
                              shuffle=shuffle, flat=flat)
        out[pkg] = _collect(it)
        assert it.provide_data[0].shape == ((5, 784) if flat
                                            else (5, 1, 28, 28))
    _assert_same(out[mxt], out[mxj])
    assert out[mxt][0][0][0].max() <= 1.0


@pytest.mark.parametrize("size,reset_internal", [(3, True), (9, True),
                                                 (9, False)])
def test_resize_iter_matches_reference(size, reset_internal):
    """Fewer batches than the inner epoch, and more (the inner iterator
    restarts), over two epochs."""
    out = {}
    for pkg in (mxt, mxj):
        it = pkg.io.ResizeIter(pkg.io.NDArrayIter(DATA, LABEL, batch_size=6),
                               size, reset_internal=reset_internal)
        first = _collect(it)
        it.reset()
        out[pkg] = first + _collect(it)
    assert len(out[mxt]) == 2 * size
    _assert_same(out[mxt], out[mxj])


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_decode_plan_matches_reference(handle):
    np.random.seed(2)
    t_it = mxt.io.NDArrayIter(DATA, LABEL, batch_size=6, shuffle=True,
                              last_batch_handle=handle)
    np.random.seed(2)
    j_it = mxj.io.NDArrayIter(DATA, LABEL, batch_size=6, shuffle=True,
                              last_batch_handle=handle)
    assert t_it.decode_plan() == j_it.decode_plan()
    for cursor in t_it.decode_plan() or []:
        _assert_same(_collect([t_it.decode_work(cursor, {})]),
                     _collect([j_it.decode_work(cursor, {})]))


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetching_iter_matches_reference(workers):
    """Two epochs of one prefetched NDArrayIter with a padded tail: one
    producer thread, or three decode threads delivering in order; the
    same batches as the JAX package's and as the iterator alone."""
    out = {}
    for pkg in (mxt, mxj):
        it = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(DATA, LABEL,
                                                       batch_size=6),
                                    num_workers=workers)
        first = _collect(it)
        it.reset()
        out[pkg] = first + _collect(it)
        it.close()
    serial = _collect(mxt.io.NDArrayIter(DATA, LABEL, batch_size=6)) * 2
    _assert_same(out[mxt], out[mxj])
    _assert_same(out[mxt], serial)


def test_prefetching_iter_merges_and_renames():
    """Two iterators merged into one batch, their names renamed."""
    out = {}
    for pkg in (mxt, mxj):
        its = [pkg.io.NDArrayIter(DATA, LABEL, batch_size=5),
               pkg.io.NDArrayIter(DATA * 2, LABEL, batch_size=5)]
        it = pkg.io.PrefetchingIter(
            its, rename_data=[{"data": "a"}, {"data": "b"}],
            rename_label=[{"softmax_label": "la"},
                          {"softmax_label": "lb"}])
        assert [d.name for d in it.provide_data] == ["a", "b"]
        assert [d.name for d in it.provide_label] == ["la", "lb"]
        out[pkg] = _collect(it)
        it.close()
    _assert_same(out[mxt], out[mxj])


def test_prefetching_iter_peek_and_eof():
    """``iter_next`` then ``next`` loses no batch; the end is sticky; a
    closed iterator reads as exhausted and ``reset`` reopens it."""
    it = mxt.io.PrefetchingIter(mxt.io.NDArrayIter(DATA, LABEL,
                                                   batch_size=5))
    seen = 0
    while it.iter_next():
        assert it.getdata()[0].shape == (5, 4)
        it.next()
        seen += 1
    assert seen == 4   # next hands over the batch iter_next peeked
    with pytest.raises(StopIteration):
        it.next()
    it.close()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    assert len(_collect(it)) == 4
    it.close()


class _Failing(mxt.io.NDArrayIter):
    """Fails to decode the batch at cursor 10."""

    def decode_work(self, cursor, tls):
        if cursor == 10:
            raise ValueError("corrupt batch")
        return super().decode_work(cursor, tls)

    def next(self):
        if self.cursor + self.batch_size == 10:
            self.cursor += self.batch_size
            raise ValueError("corrupt batch")
        return super().next()


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetching_iter_raises_in_order(workers):
    """An exception reaches the consumer at the batch where it happened,
    after every batch before it; then the epoch reads as ended."""
    it = mxt.io.PrefetchingIter(_Failing(DATA, LABEL, batch_size=5),
                                num_workers=workers)
    assert it.next().data[0].asnumpy()[0, 0] == 0
    assert it.next().data[0].asnumpy()[0, 0] == 20
    with pytest.raises(ValueError, match="corrupt"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_prefetching_iter_pool_over_image_iter(tmp_path):
    """The decode threads over ``ImageIter``'s plan (each with its own
    clone of the record file) give the serial batches."""
    from PIL import Image
    from io import BytesIO

    rng = np.random.default_rng(5)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = mxt.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(10):
        buf = BytesIO()
        Image.fromarray(rng.integers(0, 256, (20, 22, 3), dtype=np.uint8)
                        ).save(buf, format="PNG")
        w.write_idx(i, mxt.recordio.pack(
            mxt.recordio.IRHeader(0, float(i), i, 0), buf.getvalue()))
    w.close()

    def make():
        return mxt.image.ImageIter(3, (3, 16, 16), path_imgrec=rec,
                                   path_imgidx=idx)

    serial = _collect(make())
    it = mxt.io.PrefetchingIter(make(), num_workers=3)
    _assert_same(_collect(it), serial)
    it.close()


# ---------------------------------------------------------------------------
# DevicePrefetchIter on the CPU


def _module(pkg, seed=0):
    net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (5, 4))],
             label_shapes=[("softmax_label", (5,))])
    rng = np.random.default_rng(seed)
    mod.init_params(arg_params={
        "fc_weight": pkg.nd.array(rng.standard_normal((3, 4)).astype(
            np.float32) * 0.1, pkg.cpu()),
        "fc_bias": pkg.nd.array(np.zeros(3, np.float32), pkg.cpu())})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    return mod


def _train(mod, it, epochs=2):
    outs = []
    for _ in range(epochs):
        for b in it:
            mod.forward_backward(b)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        it.reset()
    return outs, {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


def test_device_prefetch_training_bit_identical():
    """Two epochs through a DevicePrefetchIter and through the plain
    iterator: equal outputs at every step and equal parameters."""
    plain = _train(_module(mxt), mxt.io.NDArrayIter(DATA, LABEL,
                                                    batch_size=5))
    mod = _module(mxt)
    dp = mod.device_prefetch(mxt.io.NDArrayIter(DATA, LABEL, batch_size=5),
                             depth=3)
    staged = _train(mod, dp)
    assert dp.staged_count >= 8 and dp.h2d_bytes >= 8 * (80 + 20)
    dp.close()
    for a, b in zip(plain[0], staged[0]):
        np.testing.assert_array_equal(a, b)
    for n in plain[1]:
        np.testing.assert_array_equal(plain[1][n], staged[1][n])


def test_device_prefetch_batches_reset_and_eof():
    """The staged batches equal the JAX package's DevicePrefetchIter's;
    the end is sticky until ``reset``; a reset in mid-epoch restarts;
    ``close`` closes the wrapped iterator."""
    j_mod = _module(mxj)
    j_dp = j_mod.device_prefetch(mxj.io.NDArrayIter(DATA, LABEL,
                                                    batch_size=5))
    want = _collect(j_dp)
    j_dp.close()
    closed = []
    inner = mxt.io.NDArrayIter(DATA, LABEL, batch_size=5)
    inner.close = lambda: closed.append(True)
    dp = _module(mxt).device_prefetch(inner)
    _assert_same(_collect(dp), want)
    with pytest.raises(StopIteration):
        dp.next()
    dp.reset()
    dp.next()
    dp.reset()
    _assert_same(_collect(dp), want)
    with pytest.raises(NotImplementedError):
        dp.iter_next()
    dp.close()
    assert closed == [True] and dp._thread is None
    with pytest.raises(StopIteration):
        dp.next()


def test_device_prefetch_delivers_errors_in_order():
    class Broken(mxt.io.NDArrayIter):
        def next(self):
            if self.cursor == 5:
                raise OSError("read failed")
            return super().next()

    dp = _module(mxt).device_prefetch(Broken(DATA, LABEL, batch_size=5))
    dp.next()
    dp.next()
    with pytest.raises(OSError, match="read failed"):
        dp.next()
    with pytest.raises(StopIteration):
        dp.next()
    dp.close()


def test_fit_env_knob_stages_and_is_bit_identical(monkeypatch):
    """``MXNET_DEVICE_PREFETCH=1``: ``fit`` wraps the training data in a
    DevicePrefetchIter of ``MXNET_DEVICE_PREFETCH_DEPTH``, closes it at the
    end, and trains to the same parameters bit for bit."""
    made = []
    orig = mxt.mod.Module.device_prefetch

    def spy(self, data_iter, depth=None):
        made.append(orig(self, data_iter, depth))
        return made[-1]

    monkeypatch.setattr(mxt.mod.Module, "device_prefetch", spy)
    got = []
    for knob in ("0", "1"):
        monkeypatch.setenv("MXNET_DEVICE_PREFETCH", knob)
        monkeypatch.setenv("MXNET_DEVICE_PREFETCH_DEPTH", "3")
        mod = _module(mxt, seed=4)
        mod.fit(mxt.io.NDArrayIter(DATA, LABEL, batch_size=5), num_epoch=3,
                optimizer_params={"learning_rate": 0.1})
        got.append({n: a.asnumpy() for n, a in mod.get_params()[0].items()})
    assert len(made) == 1 and made[0]._depth == 3 and made[0]._thread is None
    for n in got[0]:
        np.testing.assert_array_equal(got[0][n], got[1][n])
