from ray_tracying.cli.main import main, parse_args
