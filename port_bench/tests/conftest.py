import os
import sys

# the harness imports itself as `port_bench`, from the checkout's root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
