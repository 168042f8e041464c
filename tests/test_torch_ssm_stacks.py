"""The hymba-1.5b and xlstm-1.3b smoke configs whole against the JAX
package's: ``forward`` on both sides of ``MAMBA_CHUNK`` and
``MLSTM_CHUNK``, the serving engine and the serve launcher.  The slowest
of the recurrent checks, kept apart from ``test_torch_ssm.py``, whose
helpers, tolerance and smoke pairs they use (its docstring says why
1e-5 holds)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serving import engine as peng  # noqa: E402
from test_torch_ssm import (B, HYMBA, SSM_ARCHS, XLSTM, close,  # noqa: E402
                            close_tree, pair, tokens)


@pytest.mark.parametrize("arch,S", [(HYMBA, 12), (HYMBA, 1024),
                                    (XLSTM, 12), (XLSTM, 512)])
def test_forward_matches_reference(arch, S):
    """The smoke config through ``forward``; hymba at 1024 runs its mamba
    heads chunked (and its attention through the chunked softmax), xlstm
    at 512 its mLSTM chunkwise."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, S))
    jl, jaux = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)
    pl, paux = forward(pp, cfg, tokens=torch.from_numpy(toks))
    assert pl.shape == (B, S, cfg.vocab) and pl.dtype == torch.float32
    close(pl, jl)
    close(paux, jaux)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serving_engine_matches_reference(arch):
    """The serve launcher's workload (12 requests of 3-9 tokens, 8 new,
    ``max_batch=4``) on the smoke config: the reference's tokens, steps,
    page pool, session stats and every cache leaf.  The whole-batch
    prefill drives every slot's recurrent state in both packages."""
    cfg, jcfg, jp, pp = pair(arch)
    ecfg = {"max_batch": 4, "max_seq": 64}
    je = jeng.ServingEngine(jcfg, jp, jeng.EngineConfig(**ecfg),
                            session_policy="always")
    pe = peng.ServingEngine(cfg, pp, peng.EngineConfig(**ecfg),
                            session_policy="always", device="cpu")
    reqs = []
    for eng, Request in ((je, jeng.Request), (pe, peng.Request)):
        rng = np.random.default_rng(0)
        rs = [Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab, size=rng.integers(3, 10)).astype(np.int32),
            max_new=8) for i in range(12)]
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        reqs.append(rs)
    assert [(r.rid, r.done, r.generated) for r in reqs[0]] == \
        [(r.rid, r.done, r.generated) for r in reqs[1]]
    assert pe.steps == je.steps and pe.pool.free == je.pool.free
    assert pe.sessions.stats() == je.sessions.stats()
    close_tree(dict(pe.caches), je.caches)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_launcher_serves_the_recurrent_archs(arch, capsys,
                                                   monkeypatch):
    """``launch/serve.py --arch ... --device cpu`` prints the reference
    launcher's line."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    jserve.main()
    want = capsys.readouterr().out
    pserve.main(["--arch", arch, "--device", "cpu"])
    got = capsys.readouterr().out
    assert want.startswith("served 12 requests in ") and got == want
