"""The benchmark of ``soc_project_stereo_matching_tpu_torch``, the PyTorch
and CUDA port of the SGM stereo engine.

    python3 stereo_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, metric or layer is a file of
its own here, found by its name:

    configs/<config>.json       frame size, options, what was assumed
    traffic/<traffic>.json      the parameters that ``traffic.py`` reads
    feeds/<feed>.py             the loop that drives a traffic's calls
    metrics/<metric>.py         one reader a metric, ``read(record)``
    layers/<layer>/*.txt        kernel-name patterns of a layer
    reference/<reference>.py    a configuration's ``reference``, which
                                decides ``correct``; ``sgm.py``, the frozen
                                plain pipeline, where it names none

Nothing here imports JAX or the JAX package; no reference imports anything
of the port either.
"""
