"""Multi-device serving on ``torch.distributed`` (counterpart of
``qwen3tts_tpu/parallel/``): ``mesh`` (the ("dp", "tp") mesh of ranks and
the placements of sharded leaves), ``shardings`` (tensor-parallel
params), ``collectives`` (the sums and gathers the models and loops call)
and ``kernel_safety`` (the fused kernels' gate on placements).

One process per rank: every rank builds the mesh after its process group
is up and calls the same entry points with the same global inputs.
"""
