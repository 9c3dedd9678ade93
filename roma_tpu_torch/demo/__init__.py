"""The demos (counterpart of demo/), run as ``python -m
roma_tpu_torch.demo.<name> --im_A_path A --im_B_path B``: each has
``build(args, config=None)`` (the matcher) and ``run(args, model=None)``.
The sift baseline (demo/demo_match_opencv_sift.py) imports neither package
and needs no port."""
