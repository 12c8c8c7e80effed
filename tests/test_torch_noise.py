"""The port's Noise draw (``srack_tpu_torch/ops/noise_kernel.py`` and its
kernel ``csrc/noise_lanes.cu``), on the CPU.

* The plain version's words and lanes equal a numpy ``uint32`` reference
  of ``w = L(L(L(t ^ k0) ^ k1) ^ k0)`` (``L`` lowbias32), keys at the
  edges of the 64-bit range included; the kernel's host build (g++) gives
  the same bits.
* Each voice's key is the whole 64-bit ``fold_in(fold_in(key, seed), g)``
  of its index ``g`` in the batch.
* No lane is a shifted copy of another: 4,096 voices x 4,096 samples
  (2**24 words, about 2**15 coincidences of 32-bit words expected by
  chance) show the chance count of coincidences and not one whose next
  samples coincide too; nor are lanes whose keys differ in one word
  only, or by a multiple of the golden-ratio step.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
the plain version at the drums render's shape).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from srack_tpu_torch.modules.oscillator import noise_row_keys
from srack_tpu_torch.ops.basic import fold_in
from srack_tpu_torch.ops.cuda_lib import build
from srack_tpu_torch.ops.noise_kernel import (NOISE_LANES, noise_lanes,
                                              noise_lanes_plain,
                                              noise_words_plain)

HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC")
EDGE_KEYS = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1]


def _lowbias32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _words_ref(keys_u64, n):
    k = np.asarray(keys_u64, dtype=np.uint64).reshape(-1, 1)
    k0 = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k1 = (k >> np.uint64(32)).astype(np.uint32)
    t = np.arange(n, dtype=np.uint32)
    with np.errstate(over="ignore"):
        return _lowbias32(_lowbias32(_lowbias32(t ^ k0) ^ k1) ^ k0)


def _keys(rng, r):
    keys = rng.integers(0, 2 ** 64, size=r, dtype=np.uint64)
    return np.concatenate([np.array(EDGE_KEYS, dtype=np.uint64), keys])


@pytest.mark.parametrize("n", [1, 1023, 5000])
def test_plain_draw_matches_numpy_reference(n):
    keys = _keys(np.random.default_rng(n), 10)
    want = _words_ref(keys, n)
    tk = torch.from_numpy(keys.view(np.int64))
    words = noise_words_plain(tk, n)
    np.testing.assert_array_equal(words.numpy(), want.astype(np.int64))
    lanes = noise_lanes(tk, n)
    assert lanes.dtype == torch.float32 and tuple(lanes.shape) == (16, n)
    np.testing.assert_array_equal(
        lanes.numpy(), (want >> np.uint32(8)).astype(np.float32)
        * np.float32(2.0 ** -23) - np.float32(1.0))
    assert float(lanes.min()) >= -1.0 and float(lanes.max()) < 1.0


def test_plain_draw_is_the_same_in_chunks(monkeypatch):
    from srack_tpu_torch.ops import noise_kernel
    keys = torch.from_numpy(_keys(np.random.default_rng(1), 30)
                            .view(np.int64))
    whole = noise_lanes_plain(keys, 777)
    monkeypatch.setattr(noise_kernel, "CHUNK", 1000)  # one row a chunk
    assert torch.equal(noise_lanes_plain(keys, 777), whole)


def test_host_build_matches_plain(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable")
    path, _ = build(NOISE_LANES.source, compiler=gxx, flags=HOST_FLAGS,
                    root=tmp_path)
    fn = ctypes.CDLL(str(path)).srk_noise_lanes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    keys = torch.from_numpy(_keys(np.random.default_rng(2), 31)
                            .view(np.int64))
    n = 1025
    out = torch.empty((keys.shape[0], n), dtype=torch.float32)
    assert fn(keys.data_ptr(), out.data_ptr(), keys.shape[0], n) == 0
    assert torch.equal(out, noise_lanes_plain(keys, n))


def test_kernel_wrapper_takes_only_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        NOISE_LANES.run(torch.zeros(4, dtype=torch.int64), 16)


def test_row_keys_are_64_bit_fold_ins_of_the_global_voice():
    seeds = np.array([3, 9, 3, 3])
    keys = noise_row_keys(11, seeds, voice0=5).view(np.uint64)
    want = [fold_in(fold_in(11, int(s)), 5 + g) for g, s in enumerate(seeds)]
    assert [int(k) for k in keys] == want
    assert any(int(k) >> 32 for k in keys)  # the high word is kept
    # a shard's rows are the whole batch's rows from its first voice on
    whole = noise_row_keys(11, np.full(16, 3))
    np.testing.assert_array_equal(noise_row_keys(11, np.full(8, 3), 8),
                                  whole[8:])


def _shifted_copies(words):
    """Coincidences of equal words at two places of ``[V, n]`` words, and
    how many of them coincide again one sample later."""
    v, n = words.shape
    flat = words.reshape(-1)
    order = torch.argsort(flat, stable=True)
    s = flat[order]
    same = torch.nonzero(s[1:] == s[:-1]).reshape(-1)
    a, b = order[same], order[same + 1]
    # neither at the end of its row: the next samples exist
    ok = ((a % n) < n - 1) & ((b % n) < n - 1)
    again = int((flat[a[ok] + 1] == flat[b[ok] + 1]).sum())
    return same.numel(), again


def test_no_lane_is_a_shifted_copy_of_another():
    v = n = 4096
    keys = torch.from_numpy(noise_row_keys(7, np.zeros(v, dtype=np.int64)))
    words = noise_words_plain(keys, n)
    pairs, again = _shifted_copies(words)
    # every lane is a bijection of the counter: coincidences fall between
    # lanes, about C(v, 2) n^2 / 2^32 of them by chance
    expected = v * (v - 1) / 2 * n * n / 2 ** 32
    assert abs(pairs - expected) < 6 * expected ** 0.5
    assert again == 0


def test_keys_one_word_apart_are_not_copies():
    k0, k1 = 0x12345678, 0x9ABCDEF0
    golden = 0x9E3779B9
    keys = [(k1 << 32) | k0,
            (k1 << 32) | (k0 ^ 5),                        # k0 ^ d, same k1
            ((k1 ^ 1) << 32) | k0,                        # same k0
            (k1 << 32) | ((k0 + 3 * golden) & 0xFFFFFFFF)]  # t's step apart
    words = noise_words_plain(torch.tensor(
        np.array(keys, dtype=np.uint64).view(np.int64)), 4096)
    pairs, again = _shifted_copies(words)
    # by chance 6 n^2 / 2^32 = 0.02 coincidences; a copy would give 4,000
    assert pairs <= 2 and again == 0
