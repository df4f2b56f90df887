import sys

from mvsbench.run import main

sys.exit(main())
