"""distributed.cloud_utils (counterpart of
paddle_tpu/distributed/cloud_utils.py): the job's cluster layout from
the launcher's environment variables."""
import os

__all__ = ["get_cloud_cluster", "get_trainers_num"]


def get_trainers_num():
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))


def get_cloud_cluster(args_node_ips=None, args_node_ip=None,
                      args_port=None, selected_devices=None):
    """(node_ips, current_ip, trainer_endpoints) from the PADDLE_* env
    contract: PADDLE_TRAINER_ENDPOINTS when set, else one endpoint per
    node of `args_node_ips` (127.0.0.1 by default) at `args_port`
    (6170). Node ips keep their order, without duplicates."""
    endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
    eps = [e for e in endpoints.split(",") if e]
    if not eps:
        port = args_port or 6170
        ips = (args_node_ips.split(",") if args_node_ips
               else ["127.0.0.1"])
        eps = [f"{ip}:{port}" for ip in ips]
    node_ips = list(dict.fromkeys(e.rsplit(":", 1)[0] for e in eps))
    cur = args_node_ip or os.getenv("POD_IP", node_ips[0])
    return node_ips, cur, eps
