from repro_torch.serve.cli import main

raise SystemExit(main())
