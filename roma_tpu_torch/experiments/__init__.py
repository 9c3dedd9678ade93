"""The training entry points (counterpart of experiments/train_*.py), run as
``python -m roma_tpu_torch.experiments.<name>``; each module's ``build``
returns the recipe's objects for a test or a smoke run to drive."""
