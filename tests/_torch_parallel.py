"""JAX references shared by the parallelism parity tests
(tests/test_torch_tp.py, tests/test_torch_pp.py), each jitted once a
process (`functools.lru_cache`), at tests/test_pp.py's tiny configs: a
4-layer tiny OPT, the 2-layer tiny OPT KD pair (teacher and student; two
layers keep JAX's gradient compile short) and a 4-layer llama_tiny, on a
4 x 16 (OPT) or 2 x 16 (LLaMA) batch. Every JAX tree is read from the port's
seeded model (`jax_variables_from_state_dict`), and every JAX gradient comes
back as a port-named state dict (`weights.state_dict_from_jax`).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from sea_tpu.models.llama import LlamaForCausalLM as JaxLlama
from sea_tpu.models.llama import llama_tiny as jax_llama_tiny
from sea_tpu.models.opt import OptForCausalLM as JaxOpt
from sea_tpu.models.opt import cross_entropy_shifted, stack_layer_params
from sea_tpu.parallel.pp import make_pp_mesh, pp_causal_lm_forward
from sea_tpu.training.distill import SeaOptKD as JaxKD
from sea_tpu_torch import weights
from sea_tpu_torch.models.llama import LlamaForCausalLM
from sea_tpu_torch.models.opt import OptForCausalLM
from tests._torch_parity import (jax_variables_from_state_dict, torch_llama_config,
                                 torch_opt_config)
from tests.test_opt_kd import make_batch, tiny_opt

# the seeds of the port's models: the 'perlin' model, the KD teacher and
# student
MODEL_SEED, TEACHER_SEED, STUDENT_SEED = 0, 1, 2


def opt4_config(method="perlin"):
    return dataclasses.replace(tiny_opt(method), num_layers=4)


def kd_config(method):
    return tiny_opt(method)


def llama4_config():
    return dataclasses.replace(jax_llama_tiny("perlin"), num_layers=4)


def opt4_batch():
    ids, mask = make_batch(N=4, T=16, vocab=128)
    return np.asarray(ids), np.asarray(mask)


def port_opt4(method="perlin", seed=MODEL_SEED) -> OptForCausalLM:
    return OptForCausalLM(torch_opt_config(opt4_config(method)), device="cpu", seed=seed)


def port_kd(method, seed) -> OptForCausalLM:
    return OptForCausalLM(torch_opt_config(kd_config(method)), device="cpu", seed=seed)


def port_llama4(seed=MODEL_SEED) -> LlamaForCausalLM:
    return LlamaForCausalLM(torch_llama_config(llama4_config()), device="cpu", seed=seed)


def _loop_vars(jmodel, port, ids, mask):
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), ids, mask))
    return jax_variables_from_state_dict(shapes, port.state_dict())


def _scan_vars(v_loop, num_layers):
    out = {"params": stack_layer_params(v_loop["params"], num_layers)}
    if "performer" in v_loop:
        out["performer"] = stack_layer_params(v_loop["performer"], num_layers)
    return out


def port_grads(jax_grads, num_layers=None):
    """A JAX gradient tree of the params (loop layout, or scan layout with
    `num_layers`) as a port-named dict of tensors."""
    tree = jax.tree_util.tree_map(np.asarray, jax_grads)
    if num_layers is not None:
        tree = weights.unstack_layer_params(tree, num_layers)
    return weights.state_dict_from_jax({"params": tree})


@functools.lru_cache(maxsize=None)
def jax_opt4_pp():
    """JAX's GPipe (pp = 4 over 4 virtual devices, 2 microbatches) on the
    4-layer 'perlin' OPT: (logits, task loss, its gradients), one jit of
    `jax.value_and_grad` (tests/test_pp.py's forward and gradient cases)."""
    cfg = opt4_config()
    ids, mask = (jnp.asarray(x, jnp.int32) for x in opt4_batch())
    v_loop = _loop_vars(JaxOpt(cfg), port_opt4(), ids, mask)
    m_scan = JaxOpt(dataclasses.replace(cfg, scan_layers=True))
    v_scan = _scan_vars(v_loop, cfg.num_layers)
    mesh = make_pp_mesh(dp=1, pp=4, devices=jax.devices()[:4])

    def loss(p):
        logits, _ = pp_causal_lm_forward(m_scan, {**v_scan, "params": p}, ids, mask,
                                         mesh=mesh, num_microbatches=2)
        return cross_entropy_shifted(logits, ids), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v_scan["params"])
    return np.asarray(logits), float(value), port_grads(grads, cfg.num_layers)


@functools.lru_cache(maxsize=None)
def jax_kd():
    """JAX's unsharded `SeaOptKD.kd_loss` of the 2-layer OPT pair (no
    jitter): (loss, the student's gradients), one jit; the reference
    of tests/test_pp.py's KD cases at one microbatch and of the TP KD
    step."""
    t_cfg, s_cfg = kd_config("none"), kd_config("perlin")
    kd = JaxKD(t_cfg, s_cfg)
    ids, mask = (jnp.asarray(x, jnp.int32) for x in opt4_batch())
    t_vars = _loop_vars(kd.teacher, port_kd("none", TEACHER_SEED), ids, mask)
    s_vars = _loop_vars(kd.student, port_kd("perlin", STUDENT_SEED), ids, mask)
    # without remat: the same function, a lighter compile
    value, grads = jax.jit(jax.value_and_grad(
        lambda sp: kd.kd_loss(t_vars, {**s_vars, "params": sp}, ids, mask, ids,
                              use_remat=False)[0]))(s_vars["params"])
    return float(value), port_grads(grads)


@functools.lru_cache(maxsize=None)
def jax_llama4_logits():
    """JAX's loop forward of the 4-layer llama_tiny on a 2 x 16 batch."""
    cfg = llama4_config()
    ids, mask = make_batch(N=2, T=16, vocab=cfg.vocab_size)
    model = JaxLlama(cfg)
    variables = _loop_vars(model, port_llama4(), ids, mask)
    logits = jax.jit(lambda v: model.apply(v, ids, mask)["logits"])(variables)
    return np.asarray(ids), np.asarray(mask), np.asarray(logits)
