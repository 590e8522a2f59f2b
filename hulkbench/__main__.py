from hulkbench.run import main

raise SystemExit(main())
