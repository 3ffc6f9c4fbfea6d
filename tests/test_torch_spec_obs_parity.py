"""The port's cost ledger, collector and monitor on speculative serving,
held against the JAX package on the CPU: k=2 with a one-layer draft of
other weights under a token budget gives the JAX package's streams,
ledger rows (the draft pool priced by the draft's own work model, the
``spec_rejected`` waste of rolled-back rows), round spans, alerts and
registry, exactly. The JAX side runs op by op."""
import pytest

import paddle_tpu as paddle
import paddle_tpu.inference as J
import paddle_tpu_torch.inference as P
from tests.test_torch_obs_parity import (_observers, _prompts, _record,
                                         _serve)
from tests.torch_twins import (D, EMBED, W_OUT, jax_model, op_by_op,
                               port_model)
from tests.torch_twins import shared_jax_cache  # noqa: F401


@pytest.fixture(scope="module")
def tsms():
    """{package: TokenServingModel} over the same weights; the JAX side
    runs op by op for the module."""
    with op_by_op():
        jcore = jax_model()
        yield {J: J.TokenServingModel(jcore, EMBED),
               P: P.TokenServingModel(port_model(jcore), EMBED)}


def test_speculative_ledger_rows_match_jax(tsms):
    """k=2 with a one-layer draft of other weights under a token budget:
    the draft pool's rows (priced by the draft's own work model), the
    ``spec_rejected`` waste of rolled-back rows, the round spans and the
    alerts equal the JAX package's."""
    # an untied head: with the tied one both models mostly echo the
    # last token and agree
    models = {inf: inf.TokenServingModel(tsms[inf].core, EMBED, W_OUT)
              for inf in (J, P)}
    paddle.seed(99)
    jd = paddle.incubate.nn.FusedMultiTransformer(D, 4, 64, num_layers=1)
    drafts = {J: J.TokenServingModel(jd, EMBED, W_OUT),
              P: P.TokenServingModel(port_model(jd), EMBED, W_OUT)}
    kw = dict(k=2, max_batch=2, block_size=4, num_blocks=40,
              max_blocks_per_seq=10, prefill_token_budget=6)
    recs, runs = {}, {}
    for inf in (J, P):
        eng = inf.SpeculativeEngine(models[inf], drafts[inf],
                                    **_observers(inf), **kw)
        if inf is J:
            # the port packs every budgeted step into one ragged call
            eng.engine.ragged_step = "force"
        runs[inf] = _serve(eng, _prompts(5, 3, 7, 13), n_gen=8)
        recs[inf] = _record(eng)
    assert runs[P] == runs[J]
    for key in recs[J]:
        assert recs[P][key] == recs[J][key], key
    led = recs[P]["ledger"]
    assert led["totals"]["waste_rows"]["spec_rejected"] > 0
    assert led["draft_work_model"]["num_layers"] == 1
    assert recs[P]["registry"]["work.draft_tokens"] > 0
    names = {e[0] for e in recs[P]["timeline"]}
    assert {"spec_round", "draft_roll", "sample_verify",
            "verify"} <= names
