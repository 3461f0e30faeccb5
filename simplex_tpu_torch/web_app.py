"""WSGI entry point of the port (the counterpart of the repo's root
``web_app.py``).

Exposes a module-level ``app`` for any WSGI server
(``gunicorn simplex_tpu_torch.web_app:app``) and a dev-server ``main()``
on 0.0.0.0:5000 (``python -m simplex_tpu_torch.web_app``).  The app solves
on the device of ``SolverConfig.from_env()``: ``cuda`` unless
``SIMPLEX_TPU_DEVICE`` names another, so importing this module raises where
no GPU is present and the environment does not ask for the CPU
(``SIMPLEX_TPU_DEVICE=cpu``).
"""
from simplex_tpu_torch.web.app import init_app

app = init_app()


def main():
    from simplex_tpu_torch.web.microweb import run_dev_server
    run_dev_server(app, host="0.0.0.0", port=5000)


if __name__ == "__main__":
    main()
