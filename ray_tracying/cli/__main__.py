from ray_tracying.cli.main import main

raise SystemExit(main())
