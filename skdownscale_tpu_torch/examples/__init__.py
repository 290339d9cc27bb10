"""The port's examples: the JAX package's ``examples/`` on the port, each a
module with ``main(argv=None)`` that runs on the card unless given
``--device cpu`` and returns the numbers it prints::

    python -m skdownscale_tpu_torch.examples.bcsd_example [--device cpu]

``bcsd_example``, ``gard_example``, ``mbcn_example``,
``global_models_example``, ``sharded_grid``, ``full_bcsd_pipeline``,
``continental_bcsd`` and ``tutorial`` run on synthetic data
(``examples.utils``); ``make_tutorial_notebook`` and
``make_analog_notebook`` write the two notebooks beside them.  Figures go to
``--out`` (``examples/output/`` by default) when matplotlib is installed.
Importing a module of this package runs nothing.
"""
