"""The paper's evaluation topologies (twin of
``repro/configs/xlb_microbench.py``): the per-service application model (registered by name, like the
model configs) and the service graphs of the microbenchmark, bookinfo
(Fig. 12a), Bank of Anthos (Fig. 12b) and call chains."""

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, register

# Per-service application model (shared by all services in a graph).
XLB_SERVICE_MODEL = register(
    ModelConfig(
        name="xlb-service-model",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        head_dim=32,
        ffn_act="swiglu",
        source="paper §6 microbenchmark",
    )
)


@dataclass(frozen=True)
class ServiceGraph:
    """A microservice topology: services, instance counts, and call edges."""

    name: str
    services: tuple[str, ...]
    instances: dict[str, int] = field(default_factory=dict)
    # edges: (caller, callee); the entry service is services[0]
    edges: tuple[tuple[str, str], ...] = ()

    def chain(self) -> list[str]:
        """Topological call order starting at the entry service."""
        order, seen = [], set()

        def visit(s: str) -> None:
            if s in seen:
                return
            seen.add(s)
            order.append(s)
            for a, b in self.edges:
                if a == s:
                    visit(b)

        visit(self.services[0])
        return order


MICROBENCH = ServiceGraph(
    name="microbench",
    services=("client", "server"),
    instances={"client": 1, "server": 2},
    edges=(("client", "server"),),
)


def chain_graph(length: int, instances_per_service: int = 2) -> ServiceGraph:
    """Paper Fig. 8: a linear chain of `length` services."""
    names = tuple(f"svc{i}" for i in range(length + 1))
    return ServiceGraph(
        name=f"chain{length}",
        services=names,
        instances={n: (1 if i == 0 else instances_per_service)
                   for i, n in enumerate(names)},
        edges=tuple((names[i], names[i + 1]) for i in range(length)),
    )


BOOKINFO = ServiceGraph(
    name="bookinfo",
    services=("client", "productpage", "details", "reviews", "ratings"),
    instances={"client": 1, "productpage": 50, "details": 5, "reviews": 5,
               "ratings": 5},
    edges=(
        ("client", "productpage"),
        ("productpage", "details"),
        ("productpage", "reviews"),
        ("reviews", "ratings"),
    ),
)

BANK_OF_ANTHOS = ServiceGraph(
    name="bank-of-anthos",
    services=(
        "client", "frontend", "userservice", "contacts",
        "ledgerwriter", "balancereader", "transactionhistory",
    ),
    instances={
        "client": 1, "frontend": 30, "userservice": 50, "contacts": 5,
        "ledgerwriter": 5, "balancereader": 5, "transactionhistory": 5,
    },
    edges=(
        ("client", "frontend"),
        ("frontend", "userservice"),
        ("frontend", "contacts"),
        ("frontend", "ledgerwriter"),
        ("ledgerwriter", "balancereader"),
        ("frontend", "transactionhistory"),
    ),
)
