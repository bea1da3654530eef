"""alchemy_tpu_torch: lane arithmetic, primes, sampling and the plain
3-factor NTT, held bit for bit against the JAX package (exact equality)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.backend import xla
from alchemy_tpu.backend.ntt_mxu3 import intt_mxu3, ntt_mxu3, ntt_mxu3_bcast
from alchemy_tpu.nt import primes as jprimes
from alchemy_tpu.she import keys as jkeys
from alchemy_tpu.she.fast import FastParams
from alchemy_tpu_torch.backend import modarith as ma
from alchemy_tpu_torch.backend import ntt3
from alchemy_tpu_torch.nt import primes as tprimes
from alchemy_tpu_torch.she import keys as tkeys

REPO = Path(__file__).resolve().parents[1]


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(jax_out, torch_out):
    return np.array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy())


QS = (1073479681, 1073184769, 1072496641)       # ~30-bit NTT primes


@pytest.mark.parametrize("helper", ["mulhi_u32", "mul_u32_hilo", "cond_sub",
                                    "mulmod_shoup", "mulmod", "add_mod",
                                    "sub_mod", "neg_mod"])
def test_lane_helper_matches_xla(helper):
    rng = np.random.default_rng(0)
    shape = (len(QS), 512)
    q = np.array(QS, dtype=np.uint32)[:, None]
    a, b = _u32(rng, shape), _u32(rng, shape)
    # canonical operands for the mod-q add/sub/neg helpers
    ac = (a.astype(np.uint64) % q).astype(np.uint32)
    bc = (b.astype(np.uint64) % q).astype(np.uint32)
    ac[:, 0] = 0
    if helper == "mulhi_u32":
        assert _same(xla.mulhi_u32(jnp.asarray(a), jnp.asarray(b)), ma.mulhi_u32(_t(a), _t(b)))
    elif helper == "mul_u32_hilo":
        for j, t in zip(xla.mul_u32_hilo(jnp.asarray(a), jnp.asarray(b)),
                        ma.mul_u32_hilo(_t(a), _t(b))):
            assert _same(j, t)
    elif helper == "cond_sub":
        r = (a.astype(np.uint64) % (2 * q)).astype(np.uint32)
        assert _same(xla._cond_sub(jnp.asarray(r), q), ma._cond_sub(_t(r), _t(q)))
    elif helper == "mulmod_shoup":
        # w ≥ q/2 makes the companion ⌊w·2^32/q⌋ ≥ 2^31 (above int32)
        w = q - 1 - (bc % (q // 2))
        ws = ((w.astype(object) << 32) // q.astype(object)).astype(np.uint64).astype(np.uint32)
        assert ws.min() >= 1 << 31
        assert _same(xla.mulmod_shoup(jnp.asarray(a), jnp.asarray(w), jnp.asarray(ws), q),
                     ma.mulmod_shoup(_t(a), _t(w), _t(ws), _t(q)))
        assert all(ma.shoup_const(int(x), int(qq)) == xla.shoup_const(int(x), int(qq))
                   for x, qq in zip(w[:, 0], q[:, 0]))
    elif helper == "mulmod":
        assert _same(xla.mulmod(jnp.asarray(a), jnp.asarray(b), QS), ma.mulmod(_t(a), _t(b), QS))
    elif helper == "add_mod":
        assert _same(xla._add_mod(jnp.asarray(ac), jnp.asarray(bc), q),
                     ma._add_mod(_t(ac), _t(bc), _t(q)))
    elif helper == "sub_mod":
        assert _same(xla._sub_mod(jnp.asarray(ac), jnp.asarray(bc), q),
                     ma._sub_mod(_t(ac), _t(bc), _t(q)))
    else:
        assert _same(xla._neg_mod(jnp.asarray(ac), q), ma._neg_mod(_t(ac), _t(q)))


def test_widen_narrow_keep_the_bits():
    rng = np.random.default_rng(1)
    a = _u32(rng, (1000,))
    a[:4] = [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    stored = torch.from_numpy(a.view(np.int32).copy())
    wide = ma.widen(stored)
    assert np.array_equal(wide.numpy(), a.astype(np.int64))
    assert torch.equal(ma.narrow(wide), stored)


def test_primes_match():
    for m, bits, lo in ((2048, 30, False), (4096, 30, False), (65536, 30, False),
                        (64, 20, True), (3 * 7 * 16, 25, False)):
        qs_j, qs_t = [], []
        for _ in range(3):
            qs_j.append(jprimes.find_ntt_prime(m, bits, lo=lo, avoid=tuple(qs_j)))
            qs_t.append(tprimes.find_ntt_prime(m, bits, lo=lo, avoid=tuple(qs_t)))
        assert qs_j == qs_t
        for q in qs_t:
            assert tprimes.primitive_root(q) == jprimes.primitive_root(q)
            assert tprimes.root_of_unity(m, q) == jprimes.root_of_unity(m, q)
            assert tprimes.units_of_modulus(q) == jprimes.units_of_modulus(q)


def test_sampling_matches():
    qs = (1073479681, 12289)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for var in (1.0, 3.2):
        assert np.array_equal(jkeys.gaussian_coeffs(ra, var, 257),
                              tkeys.gaussian_coeffs(rb, var, 257))
        assert np.array_equal(jkeys.uniform_residues(ra, qs, 257),
                              tkeys.uniform_residues(rb, qs, 257))


def test_split3():
    for log_n, want in ((10, (32, 32, 1)), (11, (32, 32, 2)), (12, (64, 64, 1)),
                        (14, (128, 128, 1)), (15, (128, 128, 2)), (16, (128, 128, 4))):
        assert ntt3._split3(1 << log_n) == want


def _check_ntt3(log_n, nlimb):
    p = FastParams.make(log_n, nlimb)
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, (2, p.n)) for q in p.qs], axis=1).astype(np.uint32)
    y = ntt3.ntt3(_t(x), p.n, p.qs)                    # leading batch dim
    assert _same(ntt_mxu3(jnp.asarray(x), p.n, p.qs), y)
    assert _same(intt_mxu3(jnp.asarray(np.asarray(y).astype(np.uint32)), p.n, p.qs),
                 ntt3.intt3(y, p.n, p.qs))
    assert np.array_equal(ntt3.intt3(y, p.n, p.qs).numpy(), x.astype(np.int64))
    rows = _u32(rng, (2, 3, p.n))                      # unreduced digit rows
    assert _same(ntt_mxu3_bcast(jnp.asarray(rows), p.n, p.qs),
                 ntt3.ntt3_bcast(_t(rows), p.n, p.qs))


@pytest.mark.parametrize("log_n", [10, 11, 12])
def test_ntt3_matches_ntt_mxu3(log_n):
    _check_ntt3(log_n, 3)


@pytest.mark.slow
@pytest.mark.parametrize("log_n", [14, 15, 16])
def test_ntt3_matches_ntt_mxu3_full_size(log_n):
    _check_ntt3(log_n, 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import alchemy_tpu_torch.she.fast, alchemy_tpu_torch.she.hybrid\n"
        "import alchemy_tpu_torch.convert, alchemy_tpu_torch.examples.deep_circuit\n"
        "import alchemy_tpu_torch.backend.cuda.build, alchemy_tpu_torch.backend.cuda.rescale\n"
        "import alchemy_tpu_torch.nt.factor, alchemy_tpu_torch.nt.crtset\n"
        "import alchemy_tpu_torch.core.params, alchemy_tpu_torch.core.ring, alchemy_tpu_torch.core.cyc\n"
        "import alchemy_tpu_torch.backend.golden, alchemy_tpu_torch.backend.torch_backend\n"
        "import alchemy_tpu_torch.backend.checked\n"
        "import alchemy_tpu_torch.she.ct, alchemy_tpu_torch.she.keys, alchemy_tpu_torch.she.gadget\n"
        "import alchemy_tpu_torch.she.bgv, alchemy_tpu_torch.she.linear, alchemy_tpu_torch.she.tunnel\n"
        "import alchemy_tpu_torch.she.convert, alchemy_tpu_torch.examples.common\n"
        "from alchemy_tpu_torch.backend import get_backend\n"
        "from alchemy_tpu_torch.backend.torch_backend import TorchBackend\n"
        "from alchemy_tpu_torch.examples.common import dec_to_crt\n"
        "dec_to_crt(128, 448, 32); TorchBackend('cpu'); get_backend('golden')\n"
        "import alchemy_tpu_torch.lang, alchemy_tpu_torch.lang.ir, alchemy_tpu_torch.lang.dsl\n"
        "import alchemy_tpu_torch.lang.rescale_tree, alchemy_tpu_torch.interp\n"
        "import alchemy_tpu_torch.interp.accumulator, alchemy_tpu_torch.interp.noise\n"
        "import alchemy_tpu_torch.interp.infer, alchemy_tpu_torch.interp.pprint\n"
        "import alchemy_tpu_torch.interp.size, alchemy_tpu_torch.interp.dup\n"
        "import alchemy_tpu_torch.interp.params_print, alchemy_tpu_torch.interp.keys_hints\n"
        "import alchemy_tpu_torch.interp.pt2ct, alchemy_tpu_torch.interp.eval\n"
        "import alchemy_tpu_torch.interp.error_writer, alchemy_tpu_torch.she.noise_probe\n"
        "import alchemy_tpu_torch.examples.arithmetic, alchemy_tpu_torch.examples.tunnel\n"
        "import alchemy_tpu_torch.examples.homomrlwr, alchemy_tpu_torch.examples.all_main\n"
        "from alchemy_tpu_torch.examples.arithmetic import M_MAP, PT, ZQS, addMul\n"
        "from alchemy_tpu_torch.interp.keys_hints import KeysHints\n"
        "from alchemy_tpu_torch.interp.pt2ct import pt2ct\n"
        "from alchemy_tpu_torch.she.gadget import TrivGad\n"
        "import alchemy_tpu_torch.interp.jit_exec, alchemy_tpu_torch.she.serialize\n"
        "import alchemy_tpu_torch.backend.ntt\n"
        "from alchemy_tpu_torch.core.cyc import Cyc\n"
        "from alchemy_tpu_torch.examples.arithmetic import M, ZP\n"
        "from alchemy_tpu_torch.interp.jit_exec import jit_compile\n"
        "bk = TorchBackend('cpu')\n"
        "compiled = pt2ct(addMul, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(),\n"
        "                 ctx=KeysHints(3.0, bk=bk))\n"
        "pt = Cyc.constant(M, (ZP,), 1, bk)\n"
        "args = [compiled.encrypt_arg(pt, 0), compiled.encrypt_arg(pt, 1)]\n"
        "jit_compile(compiled, args)(*args)\n"
        "import alchemy_tpu_torch, alchemy_tpu_torch.nt, alchemy_tpu_torch.she\n"
        "import alchemy_tpu_torch.parallel, alchemy_tpu_torch.parallel.dist\n"
        "import alchemy_tpu_torch.parallel.pipeline, alchemy_tpu_torch.parallel.multihost\n"
        "import alchemy_tpu_torch.parallel.dryrun, torch\n"
        "import alchemy_tpu_torch.parallel.spmd, alchemy_tpu_torch.parallel.bench_scaling\n"
        "import alchemy_tpu_torch.native, alchemy_tpu_torch.utils.profiling\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'alchemy_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
