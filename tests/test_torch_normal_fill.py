"""The scheme of the ``normal_fill`` kernel (``csrc/normal_fill.cu``), in
NumPy, against NumPy's own generator.

``kernels/normal_fill.py`` carries the kernel's phases over
``bit_generator.random_raw`` (``chunked_standard_normal``), its PCG64
jump-ahead and the ziggurat tables read from the kernel's source.  These
tests hold them against ``Generator.standard_normal`` and
``bit_generator.advance`` bit for bit: every normal, and the stream's
position after the fill.  The kernel itself is held against the
benchmark's frozen generators on the card by ``tests/test_torch_cuda.py``.
The file imports nothing of the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import common, kmeans, linreg  # noqa: E402
from repro_torch.kernels import normal_fill as nf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _words(rng):
    return nf.pcg64_words(rng.bit_generator.state)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("delta", [0, 1, 2, 511, 512, 513, 3 * 512 + 7, 10**12 + 3, 2**64 + 5,
                                   2**127 + 1])
def test_jump_ahead_matches_bit_generator_advance(delta):
    s, inc = _words(np.random.default_rng(11))
    bg = np.random.PCG64(11)
    bg.advance(delta)
    assert nf.advance(s, inc, delta) == bg.state["state"]["state"]


@pytest.mark.parametrize("c", [0, 1, 2, 3, 255, 40_321, 2**31 - 1])
def test_a_chunk_thread_finds_the_state_advance_finds(c):
    """The kernel's table jumps (one a set bit of the chunk index) land
    where ``bit_generator.advance(c * CHUNK)`` does."""
    s, inc = _words(np.random.default_rng(12))
    bg = np.random.PCG64(12)
    bg.advance(c * nf.CHUNK)
    assert nf.chunk_state(s, inc, c) == bg.state["state"]["state"]


def test_the_tables_are_numpys():
    """Spot values of NumPy's ziggurat_constants.h, and their shape: fi
    falls from 1, wi is positive, ki stays below 2^52."""
    ki, wi, fi = nf.tables()
    assert [int(ki[i]) for i in (0, 1, 2, 255)] == [0x000EF33D8025EF6A, 0, 0x000C08BE98FBC6A8,
                                                    4251099761679434]
    assert [wi[i] for i in (0, 1, 255)] == [8.683627060801306e-16, 4.779330175727737e-17,
                                            8.113849337656484e-16]
    assert [fi[i] for i in (0, 1, 255)] == [1.0, 0.9771017012676716, 0.001260285930498598]
    assert np.all(np.diff(fi) < 0) and np.all(wi > 0) and int(ki.max()) < 2**52


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
@pytest.mark.parametrize("n", [1, 5, 511, 1000, 5 * 512 + 3, 200_001])
def test_the_chunked_parse_equals_standard_normal(seed, n):
    """Shorter than a chunk, odd, many chunks: every normal bit for bit,
    and the stream ends where NumPy's does."""
    rng = np.random.default_rng(seed)
    s, inc = _words(rng)
    got = nf.chunked_standard_normal(s, inc, n)
    assert _same(got.z, rng.standard_normal(n))
    assert nf.advance(s, inc, got.spent) == rng.bit_generator.state["state"]["state"]


@pytest.mark.parametrize("n,p", [(300, 7), (1001, 3)])
def test_x_then_noise_is_one_stream(n, p):
    """Linear regression's X, then its noise, is one stream of n (p + 1)
    normals; so are a blob fill's labels (integers draw whole raw words;
    the odd half they buffer is never read by the normals) and its rows."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, p))
    noise = rng.standard_normal(n)
    s, inc = _words(np.random.default_rng(3))
    assert _same(nf.chunked_standard_normal(s, inc, n * (p + 1)).z,
                 np.concatenate([X.ravel(), noise]))
    rng = np.random.default_rng(4)
    rng.integers(0, 4, size=n)               # n odd: half a raw word left in the buffer
    s, inc = _words(rng)
    assert rng.bit_generator.state["has_uint32"] == n % 2
    assert _same(nf.chunked_standard_normal(s, inc, n * p).z, rng.standard_normal(n * p))


def _crossing_tokens(s, inc, n):
    """For each chunk boundary the stream crosses inside a token: the
    draws of that token (2: a wedge, 3 or more: the tail)."""
    got = nf.chunked_standard_normal(s, inc, n)
    draws = nf._Draws(s, inc)
    out = []
    for c, entry in enumerate(got.entries[1:], start=1):
        if entry:
            q = c * nf.CHUNK + entry
            for start in range(q - 1, max(q - 64, 0), -1):   # the token ending at q
                made, _, k = draws.token(start)
                if start + k == q and k > entry:
                    out.append(k)
                    break
    return got, out


def test_chunk_boundaries_inside_wedge_and_tail_tokens():
    """Seeds whose streams cross chunk boundaries inside a wedge token and
    inside a tail token: the summaries' entry offsets carry them, and the
    normals and the end of the stream are NumPy's."""
    n = 60_000
    kinds = set()
    for seed in range(40):
        rng = np.random.default_rng(1000 + seed)
        s, inc = _words(rng)
        got, crossing = _crossing_tokens(s, inc, n)
        found = {"wedge" if k == 2 else "tail" for k in crossing} - kinds
        if found:
            assert _same(got.z, rng.standard_normal(n))
            assert nf.advance(s, inc, got.spent) == rng.bit_generator.state["state"]["state"]
            kinds |= found
        if kinds == {"wedge", "tail"}:
            break
    assert kinds == {"wedge", "tail"}


@pytest.mark.parametrize("chunk,threads", [(8, 1), (8, 700), (16, 500), (32, 64)])
def test_reparses_and_unknown_segment_boundaries_stay_exact(chunk, threads):
    """Short chunks and one entry offset send exits past the summaries at
    chunk and segment boundaries: the serial re-parses and the segments
    standing in for one entry still give NumPy's stream."""
    rng = np.random.default_rng(21)
    s, inc = _words(rng)
    got = nf.chunked_standard_normal(s, inc, 20_000, chunk=chunk, entries=1, threads=threads)
    assert got.reparses > 0 and (got.stand_ins > 0 or threads == 1)
    assert _same(got.z, rng.standard_normal(20_000))
    assert nf.advance(s, inc, got.spent) == rng.bit_generator.state["state"]["state"]


def test_the_plain_op_gives_the_fills_bytes():
    """``ops.normal_fill`` on CPU tensors: the blob epilogue is the host's
    float32 rows, float64 with noise is linear regression's X and noise;
    no kernel launches."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, size=301)
    centers = rng.standard_normal((4, 13)) * 4.0
    X = torch.empty((301, 13), dtype=torch.float32)
    ops.normal_fill(rng.bit_generator.state, X, centres=torch.from_numpy(centers),
                    labels=torch.from_numpy(y.astype(np.int32)))
    want, want_y = common.make_blobs(5, 301, 13, 4)
    assert _same(X.numpy(), want.astype(np.float32)) and np.array_equal(y, want_y)

    X = torch.empty((200, 9), dtype=torch.float64)
    z = torch.empty(200, dtype=torch.float64)
    ops.normal_fill(np.random.default_rng(6).bit_generator.state, X, noise=z)
    rng = np.random.default_rng(6)
    assert _same(X.numpy(), rng.standard_normal((200, 9)))
    assert _same(z.numpy(), rng.standard_normal(200))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_the_op_refuses_what_it_does_not_take():
    st = np.random.default_rng(0).bit_generator.state
    with pytest.raises(TypeError):
        ops.normal_fill(st, torch.empty(4, dtype=torch.float16))
    with pytest.raises(ValueError):       # float32 rows need centres and labels
        ops.normal_fill(st, torch.empty((4, 2), dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.normal_fill(st, torch.empty((4, 2), dtype=torch.float32),
                        centres=torch.zeros((3, 5), dtype=torch.float64),
                        labels=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.normal_fill(np.random.Generator(np.random.MT19937(0)).bit_generator.state,
                        torch.empty(4, dtype=torch.float64))


def test_the_cpu_fills_keep_their_bytes():
    """On ``device="cpu"`` the fills stay NumPy's: K-means' and linear
    regression's against their host generators."""
    X = kmeans.fill_fragment(3, 257, 11, device="cpu")
    assert _same(X.numpy(), kmeans._np_fill_fragment(3, 257, 11).astype(np.float32))
    X, y = linreg.lr_fill_fragment(4, 123, 7, device="cpu")
    wX, wy = linreg._np_fill_fragment(4, 123, 7)
    assert _same(X.numpy(), wX) and _same(y.numpy(), wy)
    assert _same(linreg.lr_genpred(9, 31, 7, device="cpu").numpy(), linreg._np_genpred(9, 31, 7))
