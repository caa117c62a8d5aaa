"""The port's command line: ``python -m tpu_ffv1_torch`` (cli/main.py),
the streaming server (cli/serve.py, cli/ffserver_conf.py) and the player
(cli/play.py)."""
