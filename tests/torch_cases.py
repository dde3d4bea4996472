"""Kernel inputs shared by the port's tests, made with numpy from a seed so
that the JAX package and the port see the same values.  Imports neither
``jax`` nor ``repro``, so the ``cuda`` tests that use it also run on a
machine that has only PyTorch."""
import numpy as np

# decode attention: B rows, G kv groups of QH query heads, head dim D,
# pool pages of PS tokens, MP table columns a row
B, G, QH, D, PS, MP = 4, 2, 2, 32, 8, 8
LENS = [0, 1, 17, 40]


def mask_case(b, v, seed):
    """Logits (B, V) f32 and packed uint32 words (B, ceil(V/32)) with the
    tail bits past V zero: row 0 random, row 1 (if any) all illegal,
    row 2 (if any) ties among legal tokens at the maximum."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, v)).astype(np.float32)
    w = -(-v // 32)
    words = rng.integers(0, 2 ** 32, size=(b, w), dtype=np.uint64) \
        .astype(np.uint32)
    if v % 32:
        words[:, -1] &= np.uint32((1 << (v % 32)) - 1)
    if b > 1:
        words[1] = 0
    if b > 2:
        words[2] = 0xFFFFFFFF
        if v % 32:
            words[2, -1] = np.uint32((1 << (v % 32)) - 1)
        logits[2, ::3] = 5.0
    return logits, words


def paged_case(s_win, seed, garbage=1e3, lens=LENS, qh=QH, g=G, d=D, ps=PS,
               mp=MP):
    """q (B,S,g,qh,d), k/v pools (1 + B*mp, ps, g, d), lengths (B,) and a
    block table (B, mp), B = len(lens): each row's pages are a shuffled
    draw, vacancies -1; pages no row owns (and the trash page) hold
    ``garbage``."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    n_pages = 1 + b * mp
    kp = rng.normal(size=(n_pages, ps, g, d)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, g, d)).astype(np.float32)
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tbl = np.full((b, mp), -1, np.int32)
    owned = []
    for i, ln in enumerate(lens):
        n = -(-(ln + s_win - 1) // ps)
        tbl[i, :n] = perm[:n]
        owned += perm[:n]
        del perm[:n]
    foreign = np.ones(n_pages, bool)
    foreign[owned] = False
    kp[foreign] = garbage
    vp[foreign] = -garbage
    q = rng.normal(size=(b, s_win, g, qh, d)).astype(np.float32)
    return q, kp, vp, np.asarray(lens, np.int32), tbl


def mamba_inputs(b, s, d, n, seed):
    """Selective-scan operands at the scales of ``tests/test_kernels.py``:
    dt (B,S,d) = 0.1 |N(0,1)|, x (B,S,d), bmat / cmat (B,S,N), a (d,N) =
    -|N(0,1)|, h0 (B,d,N), all float32."""
    rng = np.random.default_rng(seed)
    return (np.abs(rng.normal(size=(b, s, d))).astype(np.float32) * 0.1,
            rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            -np.abs(rng.normal(size=(d, n))).astype(np.float32),
            rng.normal(size=(b, d, n)).astype(np.float32))


def ssd_inputs(b, s, h, d, n, seed):
    """SSD-scan operands at the scales of ``tests/test_kernel_ssd.py``:
    x (B,S,H,D), b / c (B,S,N), ld (B,S,H) = -0.3 |N(0,1)|, dt (B,S,H) =
    0.2 |N(0,1)|, h0 (B,H,D,N), all float32."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            -np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.3,
            np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.2,
            rng.normal(size=(b, h, d, n)).astype(np.float32))


def split_case(s_win, seed, h=QH, r=16, d2=8, garbage=1e3, lens=LENS,
               ps=PS, mp=MP):
    """Absorbed-MLA split-score inputs over one KV group: q (B,S,1,h,r),
    q2 (B,S,1,h,d2), a latent pool (1 + B*mp, ps, 1, r) that is both key
    and value, a rope pool (1 + B*mp, ps, 1, d2), lengths (B,) = ``lens``
    and a shuffled block table (B, mp) with -1 vacancies; pages no row owns
    hold ``garbage``."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * mp
    lat = rng.normal(size=(n_pages, ps, 1, r)).astype(np.float32)
    rp = rng.normal(size=(n_pages, ps, 1, d2)).astype(np.float32)
    perm = list(rng.permutation(np.arange(1, n_pages)))
    tbl = np.full((B, mp), -1, np.int32)
    owned = []
    for i, ln in enumerate(lens):
        n = -(-(ln + s_win - 1) // ps)
        tbl[i, :n] = perm[:n]
        owned += perm[:n]
        del perm[:n]
    foreign = np.ones(n_pages, bool)
    foreign[owned] = False
    lat[foreign] = garbage
    rp[foreign] = -garbage
    q = rng.normal(size=(B, s_win, 1, h, r)).astype(np.float32)
    q2 = rng.normal(size=(B, s_win, 1, h, d2)).astype(np.float32)
    return q, q2, lat, rp, np.asarray(lens, np.int32), tbl


def byte_mask_case(b, v, seed):
    """Logits (B, V) f32 and a (B, V) bool mask with the rows of
    ``mask_case``: row 1 (if any) all illegal, row 2 (if any) ties among
    legal tokens at the maximum; plus the mask's packed uint32 words."""
    logits, words = mask_case(b, v, seed)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    mask = bits.reshape(b, -1)[:, :v].astype(bool)
    return logits, mask, words


# -- a rank of a sharded training world ------------------------------------------


def sharded_train_step(rank, cases, mesh_shape, ocfg_kw):
    """One AdamW step of the port on a (data, model) mesh of this world's
    ranks for each case ``(name, cfg, numpy params, numpy batch)``: the
    params bridged with ``params_from_numpy``, sharded by the port's rules,
    a step on the batch split over data, the params gathered.  Rank 0
    returns {name: (gathered params as numpy in the JAX package's layout,
    loss, grad norm, the local bytes of one param shard a rank)}."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import sharding as shr
    from repro_torch.models import act_sharding, build_model
    from repro_torch.models.convert import (params_from_numpy,
                                            params_to_numpy, tree_items)
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import full, make_train_step

    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    shr.set_axis_sizes(mesh)
    act_sharding.register_mesh(mesh)
    act_sharding.configure(("data",), "model")
    out = {}
    for name, cfg, np_params, np_batch in cases:
        model = build_model(cfg)
        params = params_from_numpy(np_params, cfg, device="cpu")
        specs = shr.param_specs(cfg, params)
        params = shr.shard_tree(mesh, params, specs)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        batch = shr.shard_tree(mesh, batch, shr.batch_specs(
            cfg, batch, batch["tokens"].shape[0], ("data",)))
        step = make_train_step(model, opt.AdamWConfig(**ocfg_kw))
        new, _, met = step(params, opt.init_state(params), batch)
        local = sum(p.to_local().numel() * p.to_local().element_size()
                    for _, p in tree_items(params))
        got = params_to_numpy(shr.gather_tree(new), cfg)
        loss, gnorm = float(full(met["loss"])), float(full(met["grad_norm"]))
        if rank == 0:
            out[name] = (got, loss, gnorm, local)
    act_sharding.register_mesh(None)
    return out

