from go_raytracer_tpu_torch.cli import main

raise SystemExit(main())
