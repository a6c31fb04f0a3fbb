"""The port's tool layer: the counterparts of the repo's ``tools/*.py``.

Each module names its reference file, runs as ``python -m
sequoia_tpu_torch.tools.<name>`` with the reference tool's options, and keeps
its own copy of what it needs (it imports nothing of JAX, of the JAX package
or of the repo's ``tests`` and ``tools`` directories).  The tools that touch
a device run on ``cuda`` unless given ``--device cpu`` and raise without
CUDA:

* ``make_example_data``, ``import_reference_artifacts``: the example
  workspace and the reference's released data artifacts (host only);
* ``parity_check``: the per-gene Pearson r gate between two
  ``test_results.pkl`` files (host only);
* ``convert_weights``: torch ``.pt``/``.bin`` or an HF snapshot directory <->
  the port's checkpoints (``torch.distributed.checkpoint``);
* ``goldens``, ``validate_real_weights``: the torch-functional oracle of the
  reference architectures, and the check that hub artifacts load and agree
  with it through the port's forwards, kernels and plain;
* ``profile_backbone``, ``profile_train_step``: the ResNet-50 extractor's
  per-stage cost, and the pieces of the ViS and HE2RNA train steps.
"""
