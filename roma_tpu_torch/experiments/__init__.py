"""The entry points (counterpart of experiments/), run as
``python -m roma_tpu_torch.experiments.<name>``: the training recipes
(``train_*``; each module's ``build`` returns the recipe's objects for a
test or a smoke run to drive), the evaluations (``eval_*``: ``build(args,
config=None)`` the matcher, ``run(args, model=None)`` the benchmark and its
JSON) and the release gate (``validate_release``)."""
