"""One module a model family, found by the configuration's ``family``
(``flbench/families/<family>.py``).  Each holds:

* ``make_data(cfg, tr, seed)``: the clients' samples and the test set,
  ``{"x", "y", "parts", "x_test", "y_test"}``, from the seed;
* ``build_trainer(cfg, fl, inputs, seed, device)``: the program's
  trainer for ``cfg`` holding those samples;
* ``reference``: the plain reference of the family's model (its
  ``init_params``, ``gradients``, ``train_cohort``, ``correct_count``,
  ``stack`` and ``Adam``).

A new family is a new module here; no file of the harness changes."""
