"""The port's LM serving (``repro_torch.serve.DecodeServer``), configs and
``lm_batch`` against the JAX reference's, on the CPU.

Both servers run the same weights (the reference's ``init_params`` at
``reduced_config``, fp32, carried across by ``params_from_reference``)
and the same prompts (``lm_batch`` of both packages, cut to lengths from
a numpy seed).  Greedy token streams must be equal, token for token; the
configs and batches equal field for field and bit for bit.  The
reference's ``tests/test_serve.py::TestDecodeServer`` is mirrored on the
port.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.serve as JS  # noqa: E402
from repro.data.pipeline import lm_batch as jax_lm_batch  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import DecodeServer, Request  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
LM_ARCHS = ["llama3-8b", "granite-3-8b", "qwen1.5-32b",
            "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = ([(s.name, s.kind, s.dims) for s in v]
                       if f.name == "shapes" else v)
    return out


def _pair(arch, seed=0):
    jcfg = reduced_config(JC.get_config(arch))
    cfg = TC.replace(TC.get_config(arch), **{
        k: v for k, v in _fields(jcfg).items() if k != "shapes"})
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed),
                            dtype=jnp.float32)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, jcfg, params, model


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3-8b")


def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    toks = lm_batch(cfg, n, 12, step=seed)["tokens"]
    return [toks[i, :int(rng.integers(1, 13))].tolist() for i in range(n)]


def _reference_server(jcfg, params, **kw):
    """The reference's ``DecodeServer``, each decode step waited for.

    Its ``step`` hands ``jnp.asarray(self.slot_pos)`` to the asynchronous
    decode and then advances ``self.slot_pos`` in place before it reads
    the logits.  On the CPU that array can share the numpy buffer, so a
    step may read positions already advanced: the reference's streams
    then vary from run to run.  Waiting for each step's result keeps the
    positions it was given; the port copies them."""
    srv = JS.DecodeServer(jcfg, params, **kw)
    decode = srv._decode
    srv._decode = lambda *a: jax.block_until_ready(decode(*a))
    return srv


@pytest.mark.parametrize("arch,slots", [("llama3-8b", 1), ("llama3-8b", 2),
                                        ("llama3-8b", 4),
                                        ("deepseek-v2-lite-16b", 2),
                                        ("qwen1.5-32b", 4)])
def test_token_streams_equal_the_references(arch, slots):
    """Eight requests of 1-12 prompt tokens and 2-6 new tokens through
    ``slots`` slots of a 16-position cache: requests join as slots free,
    idle slots decode at stale positions, and the last request (12 + 6
    tokens) ends early at max_len - 1.  Every stream equals the
    reference's."""
    cfg, jcfg, params, model = _pair(arch, seed=slots)
    prompts = _prompts(cfg, 7, seed=slots) + [list(range(1, 13))]
    news = [2, 6, 3, 5, 4, 6, 2, 6]
    jsrv = _reference_server(jcfg, params, slots=slots, max_len=16)
    srv = DecodeServer(cfg, model, slots=slots, max_len=16, device="cpu")
    for p, n in zip(prompts, news):
        assert jsrv.submit(p, max_new_tokens=n) == srv.submit(
            p, max_new_tokens=n)
    want = {r.rid: r.out_tokens for r in jsrv.run_until_drained()}
    got = {r.rid: r.out_tokens for r in srv.run_until_drained()}
    assert got == want
    assert sorted(got) == list(range(8))
    assert len(got[7]) == 4                  # positions 12, 13, 14: then 15
    assert srv.cache["kv"].dtype == torch.float32
    np.testing.assert_array_equal(srv.slot_pos, jsrv.slot_pos)


# -- tests/test_serve.py::TestDecodeServer on the port -----------------------


def test_batched_requests_complete(llama):
    cfg, _, _, model = llama
    srv = DecodeServer(cfg, model, slots=4, max_len=32, device="cpu")
    rng = np.random.default_rng(0)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, 5).tolist(),
                       max_new_tokens=4) for _ in range(6)]
    done = srv.run_until_drained()
    assert sorted(r.rid for r in done) == sorted(rids)
    for r in done:
        assert isinstance(r, Request) and r.done
        assert len(r.out_tokens) == 4
        assert all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
        assert r.t_done >= r.t_submit > 0


def test_continuous_batching_reuses_slots(llama):
    cfg, _, _, model = llama
    srv = DecodeServer(cfg, model, slots=2, max_len=32, device="cpu")
    for _ in range(5):
        srv.submit([1, 2, 3], max_new_tokens=2)
    done = srv.run_until_drained()
    assert len(done) == 5                    # 5 requests through 2 slots


def test_engine_matches_offline_decode(llama):
    """Greedy engine output == an offline prefill + decode loop."""
    cfg, _, _, model = llama
    prompt = [5, 7, 11]
    srv = DecodeServer(cfg, model, slots=1, max_len=32, device="cpu")
    srv.submit(list(prompt), max_new_tokens=3)
    got = srv.run_until_drained()[0].out_tokens
    logits, cache = T.prefill(cfg, model, torch.tensor([prompt]), max_len=32)
    want = [int(torch.argmax(logits[0]))]
    for _ in range(2):
        logits, cache = T.decode_step(cfg, model, cache,
                                      torch.tensor([want[-1]]))
        want.append(int(torch.argmax(logits[0])))
    assert got == want


# -- edges --------------------------------------------------------------------


def test_a_prompt_longer_than_the_cache_is_refused(llama):
    """The reference's ``dynamic_update_slice`` refuses a prompt longer
    than max_len; the port refuses it before prefilling.  A prompt of
    exactly max_len fits, and its first decode write is dropped."""
    cfg, _, _, model = llama
    srv = DecodeServer(cfg, model, slots=1, max_len=6, device="cpu")
    srv.submit(list(range(7)), max_new_tokens=2)
    with pytest.raises(ValueError, match="does not fit"):
        srv.step()
    srv = DecodeServer(cfg, model, slots=1, max_len=6, device="cpu")
    srv.submit(list(range(6)), max_new_tokens=3)
    done = srv.run_until_drained()
    assert len(done[0].out_tokens) == 2      # slot_pos reached max_len - 1


def test_decode_server_refuses_the_cpu_by_default(llama, monkeypatch):
    cfg, _, _, model = llama
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(cfg, model)


# -- configs and batches ------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_get_config_equals_the_references(arch):
    cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    assert isinstance(cfg, TC.LMConfig) and cfg.family == "lm"
    assert _fields(cfg) == _fields(jcfg)
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    red, jred = (reduced_config(jcfg),) * 2
    assert TC.LMConfig(**{k: v for k, v in _fields(red).items()
                          if k != "shapes"}).n_params() == jred.n_params()


def test_published_sizes():
    """The two configs served at full size on one card."""
    assert TC.get_config("llama3-8b").n_params() == 8_030_261_248
    ds = TC.get_config("deepseek-v2-lite-16b")
    assert 15.5e9 < ds.n_params() < 16.0e9
    assert ds.n_active_params() < 3e9
    assert TC.get_config("granite-3-8b").padded_vocab == 49280


@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7)])
def test_lm_batch_is_the_references_bit_for_bit(step, seed):
    for arch in ("llama3-8b", "granite-3-8b"):
        cfg = TC.replace(TC.get_config(arch), vocab_size=1000)
        jcfg = JC.replace(JC.get_config(arch), vocab_size=1000)
        got = lm_batch(cfg, 4, 9, step, seed=seed)
        want = jax_lm_batch(jcfg, 4, 9, step, seed=seed)
        assert sorted(got) == sorted(want) == ["labels", "mask", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


_BLOCKED = """
import sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch.models.transformer, repro_torch.serve.engine
import repro_torch.models.moe, repro_torch.models.layers, repro_torch.serve
import repro_torch.configs as C
for arch in C.list_archs():
    C.get_config(arch)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(leaked)
"""


def test_lm_modules_import_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
