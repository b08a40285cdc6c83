"""The port's placement rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``): for every architecture's reduced
parameter, train-state, cache and batch trees, each placement, client
axis, FSDP setting and mesh, the two give the same placement leaf by leaf
(the reference's ``PartitionSpec`` as a tuple).  Then the claims of
``tests/test_sharding_rules.py`` restated on the port at full width
(parameter trees on the ``meta`` device, no storage)."""
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.api import registry as jregistry  # noqa: E402
from repro.config import FederatedConfig as JFed  # noqa: E402
from repro.config import MeshConfig as JMesh  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.api import registry  # noqa: E402
from repro_torch.config import FederatedConfig, MeshConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tree_util import tree_map, tree_structure  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

torch.set_num_threads(1)

PLACEMENTS = ("client_sharded", "client_replicated", "client_pure",
              "dp_within_client")
M = 4                   # clients of the state trees


def _ref_specs(tree):
    return [tuple(p) for p in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, P))]


def _port_specs(values, specs):
    return tree_structure(values).flatten_up_to(specs)


def _to_jax(tree):
    """A tree of meta / fake tensors as ShapeDtypeStructs."""
    def one(t):
        if not torch.is_tensor(t):
            return jax.ShapeDtypeStruct((), jnp.int32)
        dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.int32: jnp.int32}[t.dtype]
        return jax.ShapeDtypeStruct(tuple(t.shape), dt)
    return jax.tree.map(one, tree)


_CACHE = {}


def _trees(arch):
    """(reference, port) abstract trees of the reduced ``arch``: params,
    params with a client axis, the FedBiOAcc train state, decode caches."""
    if arch in _CACHE:
        return _CACHE[arch]
    jcfg = JARCHS[arch].reduced()
    jm = jbuild(jcfg)
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jpm = jax.tree.map(lambda s: jax.ShapeDtypeStruct((M,) + s.shape,
                                                      s.dtype), jp)
    jinit, _ = jregistry.get("fedbioacc").factory(
        jm, JFed(num_clients=M, local_steps=2))
    jstate = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    tm = build_model(cfg, dtype=torch.float32)
    tp = tm.init(None)
    tpm = tree_map(lambda t: torch.empty((M,) + tuple(t.shape),
                                         dtype=t.dtype, device="meta"), tp)
    tinit, _ = registry.get("fedbioacc").factory(
        tm, FederatedConfig(num_clients=M, local_steps=2))
    mode = dryrun.TargetFake("cpu")
    with mode:
        tstate = tinit(dryrun.FakeGenerator("cpu"))
    caches = jcaches = None
    if cfg.family != "audio":
        jcaches = jax.eval_shape(lambda: jm.init_cache(2, 64))
        caches = tm.init_cache(2, 64, "meta")
    _CACHE[arch] = ((jp, jpm, jstate, jcaches), (tp, tpm, tstate, caches))
    return _CACHE[arch]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_state_specs_equal_reference(arch, multi_pod):
    (jp, jpm, jstate, jcaches), (tp, tpm, tstate, caches) = _trees(arch)
    jmesh, mesh = JMesh(multi_pod=multi_pod), MeshConfig(multi_pod=multi_pod)
    n = 0
    for placement in PLACEMENTS:
        for client_axis, (jt, tt) in ((False, (jp, tp)), (True, (jpm, tpm))):
            for fsdp in (None, False, True):
                want = _ref_specs(jrules.param_specs(
                    jt, jmesh, placement=placement, client_axis=client_axis,
                    fsdp=fsdp))
                got = _port_specs(tt, rules.param_specs(
                    tt, mesh, placement=placement, client_axis=client_axis,
                    fsdp=fsdp))
                assert got == want, (placement, client_axis, fsdp)
                n += len(got)
        want = _ref_specs(jrules.state_specs(jstate, jmesh,
                                             placement=placement))
        got = _port_specs(tstate, rules.state_specs(tstate, mesh,
                                                    placement=placement))
        assert got == want, placement
    assert n > 0
    if jcaches is not None:
        want = _ref_specs(jrules.cache_specs(jcaches, jmesh))
        got = _port_specs(caches, rules.cache_specs(caches, mesh))
        assert got == want


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_specs_equal_reference(placement, multi_pod):
    jmesh, mesh = JMesh(multi_pod=multi_pod), MeshConfig(multi_pod=multi_pod)
    for arch in sorted(ARCHS):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            batch = dryrun.input_specs(arch, shape, mesh)
            for client_axis in ((True, False) if shape == "train_4k"
                                else (False,)):
                want = _ref_specs(jrules.batch_specs(
                    _to_jax(batch), jmesh, client_axis=client_axis,
                    placement=placement))
                got = _port_specs(batch, rules.batch_specs(
                    batch, mesh, client_axis=client_axis,
                    placement=placement))
                assert got == want, (arch, shape, client_axis)


# --- the claims of tests/test_sharding_rules.py, on the port -------------

@pytest.fixture(scope="module")
def llama_params():
    return build_model(ARCHS["llama3-405b"]).init(None)


def test_llama_specs_tensor_parallel(llama_params):
    specs = rules.param_specs(llama_params, MeshConfig(),
                              placement="client_sharded", client_axis=False,
                              fsdp=False)
    stage0 = specs["body"]["stages"][0]["0_attn"]
    assert stage0["mix"]["wq"] == (None, None, "model")
    assert stage0["mix"]["wo"] == (None, "model", None)
    assert stage0["ln1"]["scale"] == (None, None)
    assert specs["head"]["w"] == (None, "model")
    assert specs["body"]["embed"]["table"] == (None, "model")


def test_llama_specs_fsdp(llama_params):
    specs = rules.param_specs(llama_params, MeshConfig(),
                              placement="client_replicated",
                              client_axis=False)
    stage0 = specs["body"]["stages"][0]["0_attn"]
    assert stage0["mix"]["wq"] == (None, "data", "model")
    assert stage0["mix"]["wo"] == (None, "model", "data")


def test_vocab_not_divisible_falls_back():
    params = build_model(ARCHS["hubert-xlarge"]).init(None)
    specs = rules.param_specs(params, MeshConfig(), client_axis=False,
                              fsdp=False)
    assert specs["head"]["w"] == ("model", None)


def test_moe_expert_parallel():
    params = build_model(ARCHS["olmoe-1b-7b"]).init(None)
    specs = rules.param_specs(params, MeshConfig(), client_axis=False,
                              fsdp=False)
    ffn = specs["body"]["stages"][0]["0_attn"]["ffn"]
    assert ffn["wi"] == (None, "model", None, None)
    assert ffn["router"] == (None, None, None)


def test_client_axis_sharding():
    params = build_model(ARCHS["gemma2-2b"]).init(None)
    lead = tree_map(lambda t: torch.empty((16,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"),
                    params)
    specs = rules.param_specs(lead, MeshConfig(), placement="client_sharded",
                              client_axis=True)
    assert specs["head"]["w"] == ("data", None, "model")
    multi = rules.param_specs(lead, MeshConfig(multi_pod=True),
                              placement="client_sharded", client_axis=True)
    assert multi["head"]["w"] == (("pod", "data"), None, "model")


def test_generic_cache_specs():
    kv = torch.empty((13, 128, 32768, 8, 128), dtype=torch.bfloat16,
                     device="meta")
    specs = rules.cache_specs([{"0_attn": (kv, kv)}], MeshConfig())
    assert specs[0]["0_attn"][0] == (None, "data", "model", None, None)


def test_placed_bytes_divides_by_the_named_axes():
    kv = torch.empty((13, 128, 32768, 8, 128), dtype=torch.bfloat16,
                     device="meta")
    tree = [{"0_attn": (kv, kv)}]
    mesh = MeshConfig()
    whole = 2 * kv.numel() * 2
    assert rules.placed_bytes(tree, rules.cache_specs(tree, mesh),
                              mesh) == whole // 256
    lead = {"w": torch.empty((32, 64), device="meta")}
    assert rules.placed_bytes(lead, {"w": (("pod", "data"), "model")},
                              MeshConfig(multi_pod=True)) == 32 * 64 * 4 // 512
