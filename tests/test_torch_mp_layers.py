"""The port's tensor-parallel layers and ``mp_ops`` at tp 2 (one job of
two gloo processes, ``test_torch_parallel.run_parts``) against the JAX
package's layers on one device, where they are the dense layers (JAX's own
``test_mp_layers.py`` holds its tp runs to that).

The model is JAX's test model: a vocab-parallel embedding, a
column-parallel up projection, gelu, a row-parallel down projection with a
bias, a column-parallel head and the parallel cross entropy. Tolerances
(f32): logits and the three AdamW steps' losses within 1e-5 relative, the
gradients gathered from the shards within 1e-5 of the largest; the mp_ops
exact (sums of small integers).
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import part, run_parts

VOCAB, HIDDEN, INNER = 64, 32, 48
RTOL = 1e-5


def _port_mp_model(weights):
    from torch import nn
    from torch.nn import functional as F

    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           ParallelCrossEntropy,
                                           RowParallelLinear,
                                           VocabParallelEmbedding)

    class MPModel(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = VocabParallelEmbedding(VOCAB, HIDDEN, device="cpu")
            self.up = ColumnParallelLinear(HIDDEN, INNER, gather_output=False,
                                           device="cpu")
            self.down = RowParallelLinear(INNER, HIDDEN,
                                          input_is_parallel=True,
                                          device="cpu")
            # vocab-sharded logits feed the parallel cross entropy
            self.head = ColumnParallelLinear(HIDDEN, VOCAB, has_bias=False,
                                             gather_output=False,
                                             device="cpu")
            self.loss = ParallelCrossEntropy()

        def forward(self, ids, labels):
            h = self.down(F.gelu(self.up(self.embed(ids))))
            logits = self.head(h)
            return logits, self.loss(logits, labels).mean()

    m = MPModel()
    for name, mod in (("embed", m.embed), ("up", m.up), ("down", m.down),
                      ("head", m.head)):
        mod.load_full(torch.from_numpy(weights[f"{name}.weight"]),
                      None if f"{name}.bias" not in weights
                      else torch.from_numpy(weights[f"{name}.bias"]))
    return m


def _tp_train(rank, world, weights, ids, labels):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.optimizer import AdamW

    P.HybridMesh(tp=2)
    m = _port_mp_model(weights)
    logits, loss = m(ids, labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    opt = AdamW(learning_rate=1e-2, parameters=m.parameters())
    losses = []
    for _ in range(3):
        opt.clear_grad()
        loss = m(ids, labels)[1]
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return {"logits": P.all_gather(logits.detach(), group="tp", axis=-1),
            "grads": grads, "losses": losses}


def _jax_tp_reference():
    """JAX's test model on one device: its weights, a batch, the gradients
    of its loss, its logits and three AdamW steps' losses."""
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.parallel import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding)
    from paddle_tpu import nn as jnn
    from paddle_tpu.jit.functional import functional_call

    class MPModel(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = VocabParallelEmbedding(VOCAB, HIDDEN)
            self.up = ColumnParallelLinear(HIDDEN, INNER,
                                           gather_output=False)
            self.down = RowParallelLinear(INNER, HIDDEN,
                                          input_is_parallel=True)
            self.head = ColumnParallelLinear(HIDDEN, VOCAB, has_bias=False)
            self.loss = ParallelCrossEntropy()

        def forward(self, ids, labels):
            logits = self.head(self.down(JF.gelu(self.up(self.embed(ids)))))
            return self.loss(logits, labels).mean()

    paddle.seed(11)
    jm = MPModel()
    # a non-zero bias, so that adding it once (not per tp rank) is checked
    jm.down.bias._replace_data(jnp.linspace(-0.5, 0.5, HIDDEN))
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    rng = np.random.RandomState(2)
    ids, labels = (rng.randint(0, VOCAB, (8, 16)) for _ in range(2))
    params = {k: v._data for k, v in jm.state_dict().items()}

    def loss_of(p):
        out = functional_call(jm, p, {}, (paddle.to_tensor(ids),
                                          paddle.to_tensor(labels)))
        return getattr(out, "_data", out)
    jgrads = jax.grad(loss_of)(params)
    logits = np.asarray((jm.head(jm.down(JF.gelu(jm.up(jm.embed(
        paddle.to_tensor(ids)))))))._data)
    step = TrainStep(jm, None, jopt.AdamW(learning_rate=1e-2,
                                          parameters=jm.parameters()))
    jlosses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
               for _ in range(3)]
    return weights, ids, labels, jgrads, logits, jlosses


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    """The one 2-rank job of this module, after JAX's reference."""
    ref = _jax_tp_reference()
    weights, ids, labels = ref[:3]
    res = run_parts([("tp_train", _tp_train,
                      (weights, torch.from_numpy(ids),
                       torch.from_numpy(labels))),
                     ("mp_ops", _mp_ops, ())],
                    2, tmp_path_factory.mktemp("tp"))
    return ref, res


def test_tp_layers_match_dense_jax(tp_job):
    (_, _, _, jgrads, logits, jlosses), res = tp_job
    res = part(res, "tp_train")
    dims = {"embed.weight": 0, "up.weight": 1, "down.weight": 0,
            "head.weight": 1}
    for r in range(2):
        np.testing.assert_allclose(res[r]["logits"].numpy(), logits,
                                   rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(res[r]["losses"], jlosses, rtol=RTOL)
    for name, g in jgrads.items():
        g = np.asarray(g)
        if name in dims:
            got = np.concatenate([res[r]["grads"][name].numpy()
                                  for r in range(2)], axis=dims[name])
        else:
            got = res[0]["grads"][name].numpy()
            np.testing.assert_array_equal(got,
                                          res[1]["grads"][name].numpy())
        np.testing.assert_allclose(got, g, atol=RTOL * np.abs(g).max(),
                                   err_msg=name)


def _mp_ops(rank, world):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.parallel import mp_ops

    P.HybridMesh(tp=2)
    out = {}
    x = torch.ones(4, 3, requires_grad=True)
    mp_ops.c_identity(x).sum().backward()
    out["identity_grad"] = x.grad
    x = (torch.arange(4.0)[:, None] + 10 * rank).requires_grad_()
    y = mp_ops.mp_allreduce(x)
    y.sum().backward()
    out["allreduce"], out["allreduce_grad"] = y.detach(), x.grad
    x = torch.arange(8.0).reshape(2, 4).requires_grad_()
    s = mp_ops.c_split(x, dim=-1)
    (s * (rank + 1)).sum().backward()
    out["split"], out["split_grad"] = s.detach(), x.grad
    x = (torch.arange(4.0).reshape(2, 2) + 10 * rank).requires_grad_()
    c = mp_ops.c_concat(x, dim=-1)
    (c * torch.arange(4.0)).sum().backward()
    out["concat"], out["concat_grad"] = c.detach(), x.grad
    x = (torch.ones(1, 2, 3) * (rank + 1)).requires_grad_()
    g = mp_ops.gather_seq_scatter_hidden(x)
    (g * torch.arange(4.0)[None, :, None]).sum().backward()
    out["gseq"], out["gseq_grad"] = g.detach(), x.grad
    x = (torch.arange(4.0)[None, :, None] * (rank + 1)).requires_grad_()
    r = mp_ops.scatter_seq_gather_hidden(x)
    (r * (rank + 1)).sum().backward()
    out["sseq"], out["sseq_grad"] = r.detach(), x.grad
    return out


def test_mp_ops_forward_and_gradients(tp_job):
    res = part(tp_job[1], "mp_ops")
    for r, o in enumerate(res):
        # identity forward, the gradient summed over tp
        np.testing.assert_array_equal(o["identity_grad"], np.full((4, 3), 2.0))
        np.testing.assert_array_equal(
            o["allreduce"], (2 * np.arange(4.0) + 10)[:, None])
        np.testing.assert_array_equal(o["allreduce_grad"], np.ones((4, 1)))
        full = np.arange(8.0).reshape(2, 4)
        np.testing.assert_array_equal(o["split"], full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["split_grad"], np.repeat(
            np.array([[1.0, 2.0]]), 2, axis=1).repeat(2, axis=0))
        np.testing.assert_array_equal(o["concat"], np.concatenate(
            [np.arange(4.0).reshape(2, 2) + 10 * i for i in range(2)], 1))
        np.testing.assert_array_equal(o["concat_grad"],
                                      np.tile([2.0 * r, 2.0 * r + 1], (2, 1)))
        np.testing.assert_array_equal(o["gseq"][0, :, 0], [1, 1, 2, 2])
        # reduce-scattered: both ranks' cotangents summed, this rank's rows
        np.testing.assert_array_equal(o["gseq_grad"][0, :, 0],
                                      2 * np.arange(4.0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["sseq"][0, :, 0],
                                      3 * np.arange(4.0)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["sseq_grad"][0, :, 0],
                                      [1, 1, 2, 2])
