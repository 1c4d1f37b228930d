"""Child process of ``tests/test_torch_generate_tp.py``: one gloo rank of
a data 2 x tensor 2 world, started as

    python tests/torch_generate_tp_child.py RANK SIZE TMPDIR

``TMPDIR/in.pkl`` holds ``{"params": JAX's init as numpy, "cfg": the
TransformerConfig fields, "greedy": a prompt, "same": a prompt of
identical rows}``.  Rank = data * 2 + tensor; the tensor ranks form a
``ProcessTensorGroup`` (each keeps its slices of the params), the data
ranks a process group over which the rows split.  Each rank writes its
decodes (greedy and sampled, with and without ``vocab_parallel``) to
``TMPDIR/out<RANK>.pkl``.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_expert_child import spawn as _spawn  # noqa: E402


def main():
    import torch
    import torch.distributed as dist

    from neural_networks_parallel_training_with_mpi_tpu_torch.interop import (
        params_from_jax,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.generate_tp import (  # noqa: E501
        generate_tp,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.models.transformer import (  # noqa: E501
        Transformer, TransformerConfig,
    )
    from neural_networks_parallel_training_with_mpi_tpu_torch.parallel import (
        megatron,
    )

    rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store",
                                                         size),
                            rank=rank, world_size=size)
    with open(tmp + "/in.pkl", "rb") as f:
        spec = pickle.load(f)
    groups = {}
    for name, lines in (("tensor", [[0, 1], [2, 3]]),
                        ("data", [[0, 2], [1, 3]])):
        for line in lines:
            pg = dist.new_group(line)
            if rank in line:
                groups[name] = pg
    tensor = megatron.ProcessTensorGroup(groups["tensor"])
    model = Transformer(TransformerConfig(**spec["cfg"]), device="cpu")
    c = model.cfg
    params = params_from_jax(spec["params"], c, "cpu")
    params = dict(params, blocks=megatron.permute_qkv(
        params["blocks"], c.d_model, c.n_heads, 2, kv_heads=c.kv_heads))
    out = {}
    for vp in (False, True):
        kw = dict(vocab_parallel=vp, data_group=groups["data"],
                  device="cpu")
        out[f"greedy_{vp}"] = generate_tp(model, params, spec["greedy"],
                                          tensor, 8, **kw).numpy()
        for key in ("sampled", "again"):
            out[f"{key}_{vp}"] = generate_tp(
                model, params, spec["same"], tensor, 8, temperature=1.0,
                generator=torch.Generator().manual_seed(11), **kw).numpy()
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(tmp, size, spec, timeout=300):
    """``size`` gloo ranks of this script on ``spec``; each rank's
    outputs."""
    return _spawn(tmp, size, spec, timeout, script=os.path.abspath(__file__))


if __name__ == "__main__":
    main()
