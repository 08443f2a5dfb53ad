"""The port's sharding rules and device grids (repro_torch.sharding.rules,
repro_torch.launch.mesh) against the reference's repro/sharding/rules.py
and repro/launch/mesh.py on the CPU, exactly (specs are names, not
numbers):

  * every arch's smoke parameters: ``param_specs`` fitted on a (4, 2) and
    a (16, 16) ("data", "model") grid equal the reference's leaf for leaf,
    a layer leaf's without the reference's leading L entry. The
    reference's ``fit_tree`` reads only ``mesh.shape[axis]``, so it gets a
    stub with the axis sizes in place of a 256-device mesh;
  * ``batch_specs`` for every kind and profile, ``cache_specs_tree`` for
    every profile, and ``PROFILES``' fields;
  * ``make_host_mesh`` / ``make_production_mesh``: the reference's
    ValueErrors, and the grids' axes and shapes;
  * the per-device bytes of the train state of qwen3-14b at 40 layers on
    (4, 1) and of llama4-scout at 48 layers on (1, 4) against the
    reference's shard arithmetic (each leaf's size over its spec's axes),
    computed from shapes only, nothing allocated;
  * ``Sharding``'s pieces: the NamedSharding layout (shard, then gather
    back);
  * the masked attention the ``perf`` and ``flashgrad`` profiles change
    (bf16 scores, ``sdpa_flash``'s forward, bf16 banded partial
    softmaxes) against the reference's under its ctx, within 1e-6.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.launch import mesh as jmesh
from repro.models import model as j_model
from repro.sharding import rules as j_rules
from repro.train import train_step as j_ts
from repro_torch.convert import model_config_from_reference_dict
from repro_torch.launch import mesh
from repro_torch.models.model import param_shapes
from repro_torch.sharding import rules
from repro_torch.train import train_step as ts

KINDS = ("train", "prefill", "decode")
TOL_PROFILE = 1e-6
# the pod grid of the reference's production mesh, and the test grids
GRIDS = {"4x2": ((4, 2), ("data", "model")),
         "16x16": ((16, 16), ("data", "model")),
         "2x4x2": ((2, 4, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub(shape, axes):
    """What the reference's rules read of a mesh: its axis names and
    sizes."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


def _grid(monkeypatch, shape, axes):
    n = int(np.prod(shape))
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(n))
    return mesh.grid_of(mesh.visible_devices("cpu"), shape, axes)


def _tcfg(jcfg):
    return model_config_from_reference_dict(dataclasses.asdict(jcfg))


def _ref_specs(tree, L, Le):
    """{port name: spec tuple} of the reference's (stacked) spec tree: a
    stacked leaf's spec for each of its layers, the L entry dropped."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in flat:
        keys = [str(k.key) for k in path]
        if keys[0] in ("layers", "enc_layers"):
            n = L if keys[0] == "layers" else Le
            for i in range(n):
                out[".".join([keys[0], str(i)] + keys[1:])] = tuple(spec)[1:]
        else:
            out[".".join(keys)] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("grid_name", ["4x2", "16x16"])
def test_param_specs_equal_the_references(arch, grid_name, monkeypatch):
    jcfg = j_get_config(arch, smoke=True)
    cfg = _tcfg(jcfg)
    shape, axes = GRIDS[grid_name]
    shapes = jax.eval_shape(functools.partial(j_model.init_params, jcfg),
                            jax.random.PRNGKey(0))
    want = _ref_specs(j_rules.fit_tree(j_rules.param_specs(shapes, jcfg),
                                       shapes, _stub(shape, axes)),
                      jcfg.n_layers, jcfg.encoder_layers)
    if grid_name == "16x16":
        monkeypatch.setenv("REPRO_TEST_DEVICES", "256")
        grid = mesh.make_production_mesh(device="cpu")
    else:
        grid = _grid(monkeypatch, shape, axes)
    tshapes = param_shapes(cfg)
    got = rules.fit_tree(rules.param_specs(tshapes, cfg), tshapes, grid)
    assert sorted(got) == sorted(want)
    assert got == want
    unfitted = _ref_specs(j_rules.param_specs(shapes, jcfg),
                          jcfg.n_layers, jcfg.encoder_layers)
    assert rules.param_specs(tshapes, cfg) == unfitted


@pytest.mark.parametrize("profile", sorted(j_rules.PROFILES))
@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-large-v3",
                                  "qwen2-vl-72b", "hymba-1.5b",
                                  "mamba2-130m"])
def test_batch_and_cache_specs_equal_the_references(arch, grid_name,
                                                    profile, monkeypatch):
    jcfg = j_get_config(arch, smoke=True)
    cfg = _tcfg(jcfg)
    shape, axes = GRIDS[grid_name]
    grid = _grid(monkeypatch, shape, axes)
    stub = _stub(shape, axes)
    jp, tp = j_rules.PROFILES[profile], rules.PROFILES[profile]
    for kind in KINDS:
        want = {k: tuple(v) for k, v in
                j_rules.batch_specs(jcfg, stub, kind, jp).items()}
        assert rules.batch_specs(cfg, grid, kind, tp) == want, kind
    want = {k: tuple(v) for k, v in
            j_rules.cache_specs_tree(jcfg, stub, jp).items()}
    assert rules.cache_specs_tree(cfg, grid, tp) == want
    assert rules.dp_axes(grid) == j_rules.dp_axes(stub)


def test_profiles_equal_the_references():
    assert sorted(rules.PROFILES) == sorted(j_rules.PROFILES)
    for k, p in j_rules.PROFILES.items():
        assert dataclasses.asdict(rules.PROFILES[k]) == dataclasses.asdict(p)


@pytest.mark.parametrize("profile", sorted(j_rules.PROFILES))
def test_make_ctx_takes_the_profile(profile, monkeypatch):
    grid = _grid(monkeypatch, (2, 2, 2), ("pod", "data", "model"))
    ctx = rules.make_ctx(grid, profile=rules.PROFILES[profile])
    jctx = j_rules.make_ctx(_stub((2, 2, 2), ("pod", "data", "model")),
                            profile=j_rules.PROFILES[profile])
    for field in ("dp_axes", "tp_axis", "seq_sharded", "bf16_scores",
                  "banded", "flash_vjp"):
        assert getattr(ctx, field) == getattr(jctx, field), field
    assert ctx.ep_size == jctx.ep_size == 2 and ctx.dp_size == 4
    assert ctx.seq_axis == jctx.seq_axis
    assert rules.make_ctx(grid, seq_sharded=False).seq_axis is None


def _ref_message(call):
    with pytest.raises(ValueError) as ei:
        call()
    return str(ei.value).replace("jax.devices()", "visible_devices()")


@pytest.mark.parametrize("model", [0, 2, 5])
def test_make_host_mesh_raises_the_references_error(model, monkeypatch):
    n = jax.device_count()
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(n))
    want = _ref_message(lambda: jmesh.make_host_mesh(model))
    with pytest.raises(ValueError) as ei:
        mesh.make_host_mesh(model, "cpu")
    assert str(ei.value) == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_raises_the_references_error(multi_pod,
                                                          monkeypatch):
    n = jax.device_count()
    monkeypatch.setenv("REPRO_TEST_DEVICES", str(n))
    want = _ref_message(lambda: jmesh.make_production_mesh(
        multi_pod=multi_pod))
    with pytest.raises(ValueError) as ei:
        mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert str(ei.value) == want


def test_grids_have_the_references_axes(monkeypatch):
    monkeypatch.setenv("REPRO_TEST_DEVICES", "512")
    pod = mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == (2, 16, 16) and pod.size == 512
    assert pod.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    one = mesh.make_production_mesh(device="cpu")
    assert one.shape == (16, 16) and len(set(one.flat)) == 1
    host = mesh.make_host_mesh(4, "cpu")
    assert host.axis_names == ("data", "model") and host.shape == (128, 4)
    assert list(host.indices())[5] == (1, 1)
    assert host.flat == (torch.device("cpu"),) * 512


def _ref_device_bytes(arch, shape, axes):
    """The reference's per-device bytes of its train state: each leaf's
    bytes over the product of its fitted spec's axis sizes."""
    jcfg = j_get_config(arch)
    stub = _stub(shape, axes)
    st = jax.eval_shape(functools.partial(j_ts.init_train_state, jcfg),
                        jax.random.PRNGKey(0))
    specs = {"params": j_rules.param_specs(st["params"], jcfg),
             "opt": {"step": P(),
                     **{k: j_rules.param_specs(st["opt"][k], jcfg)
                        for k in ("m", "v", "master")}}}
    specs = j_rules.fit_tree(specs, st, stub)
    total = 0
    for spec, leaf in zip(jax.tree.leaves(specs, is_leaf=lambda x:
                                          isinstance(x, P)),
                          jax.tree.leaves(st)):
        n = int(np.prod(leaf.shape, dtype=np.int64))
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    n //= stub.shape[a]
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("qwen3-14b", (4, 1)),
                                        ("llama4-scout-17b-a16e", (1, 4))])
def test_state_bytes_per_device_equal_the_references(arch, shape,
                                                     monkeypatch):
    axes = ("data", "model")
    want = _ref_device_bytes(arch, shape, axes)
    cfg = _tcfg(j_get_config(arch))
    got = ts.state_device_bytes(_grid(monkeypatch, shape, axes), cfg)
    assert len(got) == 4 and max(got) == want
    assert cfg.n_layers == j_get_config(arch).n_layers


@pytest.mark.parametrize("spec", [("data", "model"), (("data", "model"),
                                                      None), ("model",),
                                  (None, "data"), ()])
def test_sharding_pieces_are_the_references(spec, monkeypatch):
    """Sharding(grid, spec).shard on a (4, 2) grid: device (i, j) holds
    the block its coordinates name on the entry's axes, row-major (the
    NamedSharding layout), and gather puts the pieces back."""
    grid = _grid(monkeypatch, (4, 2), ("data", "model"))
    w = torch.arange(16 * 8, dtype=torch.float32).view(16, 8)
    sh = rules.Sharding(grid, spec)
    pieces = sh.shard(w)
    assert len(pieces) == 8 and all(p.device == torch.device("cpu")
                                    for p in pieces)
    # one device repeated: every piece is a view of the leaf
    assert all(p.untyped_storage().data_ptr()
               == w.untyped_storage().data_ptr() for p in pieces)
    assert torch.equal(sh.gather(pieces), w)
    for flat, (i, j) in enumerate(grid.indices()):
        coord = {"data": i, "model": j}
        rows, cols = 16, 8
        sl = []
        for dim, entry in zip((rows, cols), tuple(spec) + (None,) * 2):
            axes_ = [] if entry is None else (
                list(entry) if isinstance(entry, tuple) else [entry])
            n = int(np.prod([grid.axis_sizes[a] for a in axes_]))
            c = 0
            for a in axes_:
                c = c * grid.axis_sizes[a] + coord[a]
            sl.append(slice(c * dim // n, (c + 1) * dim // n))
        assert torch.equal(pieces[flat], w[tuple(sl)]), (spec, flat)


def test_sharding_pieces_own_their_storage_on_distinct_devices():
    """On a grid of distinct devices (here the CPU and the meta device)
    each piece is a copy of its own, so dropping the leaf frees it; the
    piece on the leaf's own device holds only its block."""
    from repro_torch.launch.mesh import grid_of
    grid = grid_of([torch.device("cpu"), torch.device("meta")], (2,),
                   ("data",))
    w = torch.arange(16 * 8, dtype=torch.float32).view(16, 8)
    here, there = rules.Sharding(grid, ("data",)).shard(w)
    assert torch.equal(here, w[:8]) and there.device.type == "meta"
    assert here.untyped_storage().nbytes() == 8 * 8 * 4
    assert here.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("profile", ["perf", "flashgrad"])
def test_profile_attention_paths_match_the_references(profile, dt):
    """The masked attention a profile changes -- ``_sdpa`` with bf16
    scores (perf) or as ``sdpa_flash``'s forward (flashgrad), and
    ``banded_core``'s partial softmaxes in bf16 (perf) -- against the
    reference's under its ctx on a one-device mesh, compiled with XLA's
    excess precision off (each bf16 op rounded as issued, as the port
    computes), at S 40 past hymba's smoke window 16 with its 8 meta
    tokens: within 1e-6 relative L2 (measured 0 to 6.5e-8; the profile's
    path against the default one differs by 2e-3 to 4.4e-3 but in f32
    sdpa_flash, 1.1e-7)."""
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.models import attention as j_attn
    from repro.models import moe as j_moe
    from repro_torch.models import attention as t_attn
    jcfg = j_get_config("hymba-1.5b", smoke=True)
    cfg = _tcfg(jcfg)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(7)
    H, K, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 40
    q, k, v = (rng.standard_normal((2, S, n, hd)).astype(np.float32)
               for n in (H, K, K))
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(S)[None], (2, S)))
    jmesh_ = jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2)
    jctx = j_rules.make_ctx(jmesh_, profile=j_rules.PROFILES[profile])
    assert isinstance(jctx, j_moe.ShardingCtx)
    tctx = rules.make_ctx(mesh.make_host_mesh(device="cpu"),
                          profile=rules.PROFILES[profile])
    W, M = cfg.sliding_window, cfg.meta_tokens
    jm = j_attn.make_mask(jnp.asarray(pos), jnp.asarray(pos), causal=True,
                          window=W, n_meta=M)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tm = t_attn.make_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                          window=W, n_meta=M)
    def exact(fn, *args):
        # each bf16 op rounded as issued, as the port computes
        return fn.lower(*args).compile(compiler_options={
            "xla_allow_excess_precision": False})(*args)
    want = exact(jax.jit(lambda a, b, c, m: j_attn._sdpa(a, b, c, m, jcfg,
                                                         jctx)),
                 jq, jk, jv, jm)
    with torch.no_grad():
        got = t_attn._sdpa(tq, tk, tv, tm, cfg, tctx)

    def rel(a, b):
        a = a.float().numpy().astype(np.float64)
        b = np.asarray(b, np.float32).astype(np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, want) <= TOL_PROFILE, rel(got, want)
    if profile == "perf":
        want = exact(jax.jit(lambda a, b, c: j_attn.banded_core(
            a, b, c, jnp.asarray(pos), jcfg, window=W, n_meta=M,
            ctx=jctx)), jq, jk, jv)
        with torch.no_grad():
            got = t_attn.banded_core(tq, tk, tv, torch.from_numpy(pos), cfg,
                                     window=W, n_meta=M, ctx=tctx)
        assert rel(got, want) <= TOL_PROFILE, rel(got, want)
