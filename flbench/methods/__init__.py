"""One module a federated method, found by the traffic mix's ``method``
(``flbench/methods/<method>.py``).  Each holds what the harness and the
check need to know of that method:

* ``run(trainer, net, run_cfg, tr)``: the program's run of the method
  on the harness's trainer and network, which returns its history;
* ``start_round(rnd, seed, client)``: the round whose global model an
  update that trained under data seed ``seed`` and was merged in round
  ``rnd`` started from;
* ``warm(trainer, tr, params, sizes)``: the program's training of every
  cohort size in ``sizes`` once, as the method's rounds call it;
* ``schedule(net, tr, seed, accuracy)``: the plain reference's replay
  of the method's rounds (``flbench/reference/schedule.py``);
* ``merge(tr, start, trained, alphas)``: the plain reference's merge of
  one round's trained models (``flbench/reference/merge.py``).

A new method is a new module here (and its reference beside the
others); no file of the harness changes."""
